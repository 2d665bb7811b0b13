# Port copy of karpenter_tpu/solver/encode.py.
"""Host-side encoder: SolverInput -> dense tensors for the TPU solver.

This is the bridge between the control plane's object model and the device
kernel (BASELINE.json north_star: "dense pod×instance-type resource-fit
tensors plus boolean constraint masks"). It performs:

  1. **Group compression** — pods with identical scheduling footprint dedupe
    into groups (the reference batches identical pods the same way; SURVEY.md
    §7 "hard parts": pairwise [P,P] terms explode at 50k pods otherwise).
  2. **Run splitting** — the exact FFD pod order (SPEC.md) is cut into runs
    of consecutive same-group pods, so the device scan processes "k identical
    pods" per step while preserving bit-identical pod order.
  3. **Quantization** — cpu milli / memory+storage MiB / counts, all int32.
    Pod requests round UP, capacities round DOWN (conservative; never
    over-packs). Both backends receive the SAME quantized numbers, so
    decisions stay bit-identical (SPEC.md "Determinism").
  4. **Mask precomputation** — [G,T] requirement compatibility, [G,E] existing
    node compatibility, [G,P] nodepool admission, [P,T] pool-type admission,
    [T,Z,C] offering availability/price, [G,G] pairwise group compatibility.

Pods the device kernel cannot express (OR'd node-affinity alternatives,
custom-topology-key terms — including custom-key weighted antis,
stacked positive hostname terms, kind-2 groups
that are also domain-constrained, single pods domain-constrained on BOTH
the zone and ct axes, or ≥3-way custom-label joint conflicts) are flagged
`fallback` — the hybrid solver routes those to the reference path (see
karpenter_tpu/solver/backend.py). Respect-mode preferences on the known
keys (ScheduleAnyway spreads, weighted positive affinity, preferred node
affinity, zone/ct/hostname weighted antis) are served on device by the
relax loop (solver/relax.py), which materializes them as required — or,
for antis, admission-only kind-3 — constraints before this encoder runs. Zone-
and capacity-type-granular spread/affinity run ON DEVICE — including solves
MIXING the two axes (concatenated domain columns, per-group axis binding) —
as does positive hostname affinity (V domain axis / Q kind 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import wellknown as wk
from ..api.objects import Pod, tolerates_all
from ..provisioning.scheduler import (
    ExistingNode,
    NodePoolSpec,
    SolverInput,
    ffd_sort,
    ffd_sort_with_sigs,
)
from ..scheduling.requirements import Requirements
from ..utils.resources import CPU, EPHEMERAL_STORAGE, MEMORY, PODS, Resources

MIB = 1024**2
INT32_MAX = np.int32(2**31 - 1)


class UnpackableInput(ValueError):
    """The input exceeds a device-kernel packing bound (e.g. Z*C > 32 joint
    offering bits); the hybrid solver falls back to a host path. A dedicated
    type so fallback handlers don't swallow unrelated ValueErrors."""


def mesh_run_blocks(run_group: np.ndarray, run_count: np.ndarray,
                    n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Partition the PADDED run axis into `n_shards` equal contiguous blocks
    for the mesh-sharded solve: [Sp] -> [n_shards, Sp/n_shards].

    Alignment contract: backend.host_kernel_args buckets S with
    mult=floor=16 (= ffd.SHARD_BLOCK_MULT), so Sp is always a multiple of
    every power-of-2 mesh size up to 16 — blocks come out equal-length with
    no extra padding, and block d is exactly runs [d*Sblk, (d+1)*Sblk) of
    the one-device scan order (padding rides at the tail of the last
    blocks, where run_count == 0 steps are no-ops). Each block row is one
    slot's lane input for ffd.ffd_solve_sharded."""
    Sp = int(run_group.shape[0])
    if n_shards < 1 or Sp % n_shards:
        raise UnpackableInput(
            f"run axis Sp={Sp} does not divide into {n_shards} mesh blocks"
        )
    return (
        np.ascontiguousarray(run_group.reshape(n_shards, Sp // n_shards)),
        np.ascontiguousarray(run_count.reshape(n_shards, Sp // n_shards)),
    )


# Resource keys quantized to MiB granularity.
_MIB_KEYS = (MEMORY, EPHEMERAL_STORAGE)


def _quantize(res: Resources, keys: Sequence[str], ceil: bool) -> List[int]:
    out = []
    for k in keys:
        v = res.get_(k)
        if k in _MIB_KEYS:
            q, r = divmod(v, MIB)
            v = q + (1 if (ceil and r) else 0)
        out.append(min(int(v), int(INT32_MAX)))
    return out


def _pod_signature(pod: Pod) -> tuple:
    """Scheduling-footprint identity: pods with equal signatures behave
    identically in the solver (requests, constraints, AND labels — labels
    affect other pods' TSC/affinity selectors).

    Cached on the pod object: signatures are the encoder's only O(pods)
    Python cost, and pods are immutable during/between solves (controllers
    replace objects on update, never mutate scheduling fields in place), so
    the 50k-pod surge pays signature construction once, not once per solve."""
    sig = pod.__dict__.get("_solver_sig")
    if sig is not None:
        return sig
    sig = _pod_signature_uncached(pod)
    pod.__dict__["_solver_sig"] = sig
    return sig


# Global signature intern table: maps signature tuples to small ints so the
# per-solve group key is an int compare/hash instead of re-hashing a large
# nested tuple per pod per solve. Bounded: on overflow the table resets and
# the epoch bumps, invalidating every pod's cached id (and the compat cache
# entries keyed by (epoch, id)).
_SIG_IDS: Dict[tuple, int] = {}
_SIG_EPOCH: int = 0
_SIG_CAP = 100_000


def sig_num(pod: Pod) -> int:
    """Interned scheduling-signature id (stable within the current epoch)."""
    global _SIG_IDS, _SIG_EPOCH
    ent = pod.__dict__.get("_sig_num")
    if ent is not None and ent[0] == _SIG_EPOCH:
        return ent[1]
    if len(_SIG_IDS) >= _SIG_CAP:
        _SIG_IDS = {}
        _SIG_EPOCH += 1
        # compat-cache keys embed the epoch; entries from prior epochs are
        # unreachable forever — drop them rather than leak a generation
        _GROUP_COMPAT_CACHE.clear()
    sig = _pod_signature(pod)
    n = _SIG_IDS.setdefault(sig, len(_SIG_IDS))
    pod.__dict__["_sig_num"] = (_SIG_EPOCH, n)
    return n


def sig_nums(pods: Sequence[Pod]) -> Tuple[np.ndarray, bool]:
    """Interned ids for a batch, guaranteed mutually consistent (one epoch).

    If the intern table resets mid-batch (epoch bump), ids from before the
    bump could collide with fresh ids of different signatures — so retry once
    against the fresh table; a batch with more distinct signatures than the
    table cap falls back to batch-local interning (second value False: the
    ids are then NOT stable across calls and must not key persistent caches).
    """
    n = len(pods)
    for _ in range(2):
        e0 = _SIG_EPOCH
        arr = np.fromiter((sig_num(p) for p in pods), np.int64, n)
        if _SIG_EPOCH == e0:
            return arr, True
    local: Dict[tuple, int] = {}
    return (
        np.fromiter(
            (local.setdefault(_pod_signature(p), len(local)) for p in pods),
            np.int64,
            n,
        ),
        False,
    )


def _pod_signature_uncached(pod: Pod) -> tuple:
    return (
        tuple(sorted((k, v) for k, v in pod.requests.items() if v)),
        tuple(sorted(pod.node_selector.items())),
        tuple(
            tuple(sorted((r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than, r.require_present) for r in term.values()))
            for term in pod.node_affinity
        ),
        tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)),
        tuple(
            (t.max_skew, t.topology_key, t.when_unsatisfiable, tuple(sorted(t.label_selector.items())))
            for t in pod.topology_spread
        ),
        tuple(
            (tuple(sorted(t.label_selector.items())), t.topology_key, t.anti,
             t.weight, t.admission_only)
            for t in pod.affinity_terms
        ),
        tuple(
            (w, tuple(sorted((r.key, tuple(sorted(r.values))) for r in reqs.values())))
            for w, reqs in pod.preferred_node_affinity
        ),
        tuple(sorted(pod.meta.labels.items())),
        pod.priority,
        pod.volume_zones,
    )


@dataclass
class EncodedInput:
    # dimensions
    resource_keys: List[str]  # the R axis
    zones: List[str]  # Z axis
    capacity_types: List[str]  # C axis
    type_names: List[str]  # T axis (catalog order)
    pool_names: List[str]  # P axis (weight desc, name asc — SPEC order)

    # groups (G axis)
    group_pods: List[List[Pod]]  # pods per group, in FFD order
    group_req: np.ndarray  # [G, R] int32 (ceil)
    group_compat_t: np.ndarray  # [G, T] bool (pod reqs vs type reqs)
    group_zone: np.ndarray  # [G, Z] bool
    group_ct: np.ndarray  # [G, C] bool
    group_pool: np.ndarray  # [G, P] bool (tolerations + reqs compat)
    group_pair: np.ndarray  # [G, G] bool (pairwise requirement compatibility)
    group_fallback: np.ndarray  # [G] bool — route to reference path

    # runs (S axis): FFD order split into same-group runs
    run_group: np.ndarray  # [S] int32
    run_count: np.ndarray  # [S] int32

    # instance types
    type_alloc: np.ndarray  # [T, R] int32 (floor)
    type_capacity: np.ndarray  # [T, R] int32 — raw capacity, for limit charging
    offer_avail: np.ndarray  # [T, Z, C] bool
    offer_price: np.ndarray  # [T, Z, C] float32 (+inf where absent)
    charge_axes: np.ndarray  # [R] bool — cpu/memory participate in limit charges

    # nodepools
    pool_type: np.ndarray  # [P, T] bool (pool reqs vs type reqs + offering overlap)
    pool_zone: np.ndarray  # [P, Z] bool
    pool_ct: np.ndarray  # [P, C] bool
    pool_daemon: np.ndarray  # [P, R] int32 (daemonset overhead incl. pod count)
    pool_limit: np.ndarray  # [P, R] int32 (INT32_MAX where unlimited)
    pool_usage: np.ndarray  # [P, R] int32

    # existing nodes (E axis)
    node_free: np.ndarray  # [E, R] int32 (floor)
    node_compat: np.ndarray  # [G, E] bool (labels+taints admission)
    node_zone: np.ndarray  # [E] int32 (index into zones, -1 unknown)
    node_ct: np.ndarray  # [E] int32
    node_ids: List[str]

    # pod uids in FFD-sorted order (= concatenation of runs); decode's
    # vectorized result assembly indexes this instead of walking pod objects
    sorted_uids: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=object))

    # topology / affinity (config 3-4) — filled by encode, used by tpu kernels
    # True only for constructs still off-device (custom-key spread, positive
    # hostname affinity, mixed zone+ct domain axes, duplicate node
    # hostnames); zone- and ct-granular terms run on device via the V axis.
    has_topology: bool = False
    has_affinity: bool = False

    # tenancy (solver/tenancy.py): stamped from SolverInput.tenant_id so the
    # backend can namespace arena RESIDENCY per tenant while compile buckets
    # stay shape-keyed and shared. Never consulted by the solving math.
    tenant_id: Optional[str] = None

    # zone-granular constraints (V axis), run by the device event engine
    # (ffd.py zone loop; SPEC.md "Topology spread" / "Inter-pod affinity"):
    # v_kind 0 = zone TSC (cap = maxSkew), 1 = zone anti-affinity,
    # 2 = zone positive affinity.
    v_member: Optional[np.ndarray] = None  # [G, V] bool — pods match sig selector
    v_owner: Optional[np.ndarray] = None  # [G, V] bool — pods carry the constraint
    v_kind: Optional[np.ndarray] = None  # [V] int32
    v_cap: Optional[np.ndarray] = None  # [V] int32 (maxSkew for TSC)
    v_primary: Optional[np.ndarray] = None  # [G] int32 — group's owned zone-TSC sig (-1)
    v_aff: Optional[np.ndarray] = None  # [G] int32 — group's owned positive-affinity sig (-1)
    v_count0: Optional[np.ndarray] = None  # [V, D] int32 initial matching-pod counts
    # per-node share of v_count0 (node e contributes node_v_member[e] at its
    # domain) — lets the batched consolidation evaluator subtract a removed
    # candidate node's bound pods from the domain counts per subset
    node_v_member: Optional[np.ndarray] = None  # [E, V] int32
    # which axis the V sigs spread over — "zone" (default) or "ct": the
    # event engine is domain-generic, so capacity-type TSC/affinity runs on
    # it by presenting lex-ordered ct values as the domain axis (the D in
    # the shapes above); v_node_domain maps nodes into that axis
    v_axis: str = "zone"
    v_domains: Optional[List[str]] = None  # D axis values, lex order
    v_node_domain: Optional[np.ndarray] = None  # [E] int32 (-1 unknown)
    # mixed-axis ("mixed") extras — see ffd.ARG_SPEC tail
    sig_axis: Optional[np.ndarray] = None  # [V] i32 axis id per sig
    group_daxis: Optional[np.ndarray] = None  # [G] i32 axis per group
    node_dom2: Optional[np.ndarray] = None  # [E] i32 second-axis column (-1)

    # scheduling-class tensors (SPEC.md "Priority, preemption & gang
    # semantics"; ffd.CLASS_ARG_SPEC): per-run dense priority rank (higher
    # priority ⇒ higher rank — lossless for the strict-order comparisons
    # preemption makes), per-run gang index (-1 = no gang) into the per-gang
    # tables, and the per-gang declared size / minimum ranks. These ride a
    # SIDE table, not ffd.ARG_SPEC: the base scan is class-blind (priority
    # already orders the runs), so the frozen 36-tensor contract — arena
    # residency, AOT shapes, resume/ladder/sharded splices — stays intact.
    run_prio16: Optional[np.ndarray] = None  # [S] uint16
    run_gang: Optional[np.ndarray] = None  # [S] int32 (-1 = none)
    gang_size: Optional[np.ndarray] = None  # [NG] int32
    gang_min_ranks: Optional[np.ndarray] = None  # [NG] int32
    gang_ids: Optional[List[str]] = None  # NG axis values, lex order

    # revision stamp of the encode core this input was assembled around
    # (_EncodeCore.core_rev): same stamp ⇒ byte-identical core tables.
    # backend.host_kernel_args derives per-entry provenance tokens from it
    # so the argument arena skips hashing/uploading core-derived args.
    core_rev: int = -1
    # interned sort-signature number per group (same universe as
    # encode_cache's patch check); () when sigs were not interned. Run-list
    # prefix matching (encode_cache.run_identity) keys on these so a group
    # index means the same pod spec across two encodes.
    group_snums: tuple = ()

    @property
    def v_domain_perm(self) -> List[int]:
        """ct-mode only: indices into capacity_types in canonical v_domains
        order — THE single source of the lex tiebreak, shared by the device
        column masks (backend.kernel_args) and the native marshal swap."""
        return [self.capacity_types.index(d) for d in self.v_domains]

    @property
    def V(self) -> int:
        return 0 if self.v_kind is None else len(self.v_kind)

    # hostname-granular constraints (Q axis), handled closed-form on device:
    # per-(node, sig) matching-pod counts cap the pour. q_kind 0 = hostname
    # TSC (cap = maxSkew, floor-0 rule per SPEC.md), 1 = hostname
    # anti-affinity (owner blocked where members present and vice versa).
    q_member: Optional[np.ndarray] = None  # [G, Q] bool — group's pods match sig selector
    q_owner: Optional[np.ndarray] = None  # [G, Q] bool — group's pods carry the constraint
    q_kind: Optional[np.ndarray] = None  # [Q] int32
    q_cap: Optional[np.ndarray] = None  # [Q] int32 (maxSkew for TSC; 1 for anti)
    node_q_member: Optional[np.ndarray] = None  # [E, Q] int32 initial matching-pod counts
    node_q_owner: Optional[np.ndarray] = None  # [E, Q] int32 initial owner-pod presence

    @property
    def Q(self) -> int:
        return 0 if self.q_kind is None else len(self.q_kind)

    @property
    def G(self) -> int:
        return len(self.group_pods)

    @property
    def T(self) -> int:
        return len(self.type_names)

    @property
    def E(self) -> int:
        return len(self.node_ids)

    @property
    def P(self) -> int:
        return len(self.pool_names)


def quantize_resources(res: Resources, ceil: bool) -> Resources:
    """MiB-quantize memory-like values (requests ceil, capacities floor).

    The canonical solver arithmetic is MiB-granular (SPEC.md); feeding both
    backends identically-quantized inputs is what makes decisions
    bit-identical. Conservative direction: never over-packs."""
    out = Resources(res)
    for k in _MIB_KEYS:
        if k in out:
            q, r = divmod(out[k], MIB)
            out[k] = (q + (1 if (ceil and r) else 0)) * MIB
    return out


_QUANTIZED_TYPE_CACHE: dict = {}

# id(type) -> (type, rkeys tuple, alloc row, capacity row) — see encode()
_TYPE_ROW_CACHE: dict = {}

# pod-signature -> (catalog id-tuple, pinned types, [T] bool compat row)
_GROUP_COMPAT_CACHE: dict = {}

# Label-dict intern table + selector-match verdict cache: the Q/V member
# tables (both the [G,*] group side and the [E,*] node side) reduce to
# "does selector S match label-set L" — a pure function of content. Interning
# every distinct label dict to a small id and caching the verdict per
# (selector, label-id) turns the former per-(node, sig, bound-pod) Python
# loops into one verdict per DISTINCT (selector, label-set) plus vectorized
# gathers. Both tables clear together on overflow (verdict keys embed label
# ids, so a stale verdict can never pair with a recycled id).
_LAB_IDS: Dict[tuple, int] = {}
_LAB_CAP = 200_000
_SEL_MATCH: Dict[tuple, bool] = {}


def _lab_id(labels: dict) -> int:
    global _LAB_IDS, _SEL_MATCH
    key = tuple(sorted(labels.items()))
    n = _LAB_IDS.get(key)
    if n is None:
        if len(_LAB_IDS) >= _LAB_CAP:
            _LAB_IDS = {}
            _LAB_KEYS.clear()
            _SEL_MATCH.clear()
        n = len(_LAB_IDS)
        _LAB_IDS[key] = n
        _LAB_KEYS[n] = key
    return n


_LAB_KEYS: Dict[int, tuple] = {}  # reverse map (rebuilt lazily on clear)


def _sel_verdicts(sel_sig: tuple, lids: np.ndarray) -> np.ndarray:
    """[len(lids)] bool — does the selector match each interned label set."""
    out = np.empty(len(lids), dtype=bool)
    sel = dict(sel_sig)
    for i, lid in enumerate(lids.tolist()):
        v = _SEL_MATCH.get((sel_sig, lid))
        if v is None:
            lab = dict(_LAB_KEYS[lid])
            v = all(lab.get(k) == val for k, val in sel.items())
            _SEL_MATCH[(sel_sig, lid)] = v
        out[i] = v
    return out


def _quantize_type(it):
    """Per-InstanceType quantization, cached by object identity (the catalog
    is static across solves; 50k-pod solves must not pay a deepcopy)."""
    cached = _QUANTIZED_TYPE_CACHE.get(id(it))
    if cached is not None and cached[0] is it:
        return cached[1]
    from dataclasses import replace as _replace

    q = _replace(
        it,
        capacity=quantize_resources(it.capacity, ceil=False),
        overhead=quantize_resources(it.overhead, ceil=True),
    )
    if len(_QUANTIZED_TYPE_CACHE) > 8192:
        _QUANTIZED_TYPE_CACHE.clear()  # bound against catalog-churn growth
    _QUANTIZED_TYPE_CACHE[id(it)] = (it, q)
    return q


def _already_mib_aligned(res: Resources) -> bool:
    for k in _MIB_KEYS:
        v = res.get(k)
        if v is not None and v % MIB:
            return False
    return True


_QUANT_PODS_CACHE: Dict[tuple, list] = {}
_QUANT_PODS_CACHE_MAX = 4


def _quantized_pods(pods: list) -> list:
    """MiB-quantized pod list, cached by (mutation epoch, identity
    fingerprint): a control loop re-quantizing an unchanged 50k-pod surge
    pays a fingerprint pass instead of a per-pod alignment walk."""
    from dataclasses import replace as _replace

    from ..api.objects import pod_mutation_epoch

    n = len(pods)
    ids = None
    if n > 64:
        ids = np.fromiter(map(id, pods), np.uint64, n)
        key = (
            pod_mutation_epoch(),
            n,
            int(ids.sum(dtype=np.uint64)),
            int(np.bitwise_xor.reduce(ids)),
        )
        hit = _QUANT_PODS_CACHE.get(key)
        # exact id-array compare: the aggregate fingerprint can collide
        # between distinct live pod sets; pinned entries make ids stable
        if hit is not None and np.array_equal(ids, hit[0]):
            return hit[2]
    else:
        key = None

    def qpod(p):
        # alignment verdict cached on the pod (invalidated by field assignment,
        # objects.py Pod.__setattr__): typical requests are MiB-aligned, so a
        # 50k-pod surge pays one dict hit per pod instead of a Resources walk
        a = p.__dict__.get("_mib_aligned")
        if a is None:
            a = _already_mib_aligned(p.requests)
            p.__dict__["_mib_aligned"] = a
        if a:
            return p
        return _replace(p, requests=quantize_resources(p.requests, ceil=True))

    out = [qpod(p) for p in pods]
    if key is not None:
        if len(_QUANT_PODS_CACHE) >= _QUANT_PODS_CACHE_MAX:
            _QUANT_PODS_CACHE.pop(next(iter(_QUANT_PODS_CACHE)))
        # pin the INPUT pods too: unaligned pods are replaced in `out`, and
        # without a reference the originals could be freed and their ids
        # recycled into a colliding fingerprint (fresh pods never bump the
        # mutation epoch)
        _QUANT_PODS_CACHE[key] = (ids, tuple(pods), out)
    return out


def quantize_input(inp: SolverInput) -> SolverInput:
    """A structurally-shared copy of `inp` with all resources MiB-quantized —
    what the hybrid production path and the parity tests feed the reference
    solver so both backends see identical numbers. Only fields that actually
    need quantizing become fresh objects; everything else is shared IDENTITY
    (nothing downstream mutates pods/types), which keeps per-pod caches
    (signature, FFD key) warm across solves — typical requests like "1Gi"
    are already MiB-aligned, so a 50k-pod surge copies nothing."""
    from dataclasses import replace as _replace

    def qnode(n):
        if _already_mib_aligned(n.free):
            return n
        return _replace(n, free=quantize_resources(n.free, ceil=False))

    return SolverInput(
        pods=_quantized_pods(inp.pods),
        nodes=[qnode(n) for n in inp.nodes],
        nodepools=[
            _replace(pool, instance_types=[_quantize_type(it) for it in pool.instance_types])
            for pool in inp.nodepools
        ],
        daemonset_pods=_quantized_pods(inp.daemonset_pods),
        zones=inp.zones,
        capacity_types=inp.capacity_types,
        preference_policy=inp.preference_policy,
        state_rev=getattr(inp, "state_rev", None),
        tenant_id=getattr(inp, "tenant_id", None),
    )


@dataclass
class _EncodeCore:
    """The pod/pool/type-dependent stage of encode(), cached across solves.

    Keyed by (pod-mutation epoch, identity fingerprint of the filtered pod
    set, pool/type content-and-identity keys, axes): a control loop that
    re-solves an unchanged pending surge pays O(1) host work instead of the
    O(pods) sort/signature/grouping passes (the e2e Solve() seam's dominant
    host cost at 50k pods). Existing-node tensors and pool usage/limits are
    rebuilt every call — they change between solves."""

    zones: List[str]
    cts: List[str]
    type_names: List[str]
    pool_names: List[str]
    rkeys: List[str]
    charge_axes: np.ndarray
    group_pods: List[List[Pod]]
    group_req: np.ndarray
    group_compat_t: np.ndarray
    group_zone: np.ndarray
    group_ct: np.ndarray
    group_pool: np.ndarray
    group_pair: np.ndarray
    fallback: np.ndarray
    run_group: np.ndarray
    run_count: np.ndarray
    sorted_uids: np.ndarray
    group_reqsets: List[Requirements]
    has_topo: bool
    has_aff: bool
    hostname_sigs: Dict[tuple, int]
    zone_sigs: Dict[tuple, int]  # (axis, kind, sel_sig, cap) -> v index
    v_axis: str  # "zone" | "ct" | "mixed" — domain-axis layout of the V sigs
    sig_axis: np.ndarray  # [V] i32 — axis id per sig (0 zones, 1 cts)
    group_daxis: np.ndarray  # [G] i32 — axis a constrained group's engine uses
    q_member: np.ndarray
    q_owner: np.ndarray
    q_kind: np.ndarray
    q_cap: np.ndarray
    v_member: np.ndarray
    v_owner: np.ndarray
    v_kind: np.ndarray
    v_cap: np.ndarray
    v_primary: np.ndarray
    v_aff: np.ndarray
    type_alloc: np.ndarray
    type_capacity: np.ndarray
    offer_avail: np.ndarray
    offer_price: np.ndarray
    pool_type: np.ndarray
    pool_zone: np.ndarray
    pool_ct: np.ndarray
    pool_daemon: np.ndarray
    all_req_keys: List[str]
    zid: Dict[str, int]
    cid: Dict[str, int]
    # patch-layer identity (solver/encode_cache.py): the ordered DISTINCT
    # interned signature ids this core was built from, and the intern epoch
    # they are valid in. Every [G]/[T]/[P]-indexed table above is a pure
    # function of (this sequence, the catalog segment of the cache key), so
    # a new pod set producing the same sequence under the same epoch can
    # reuse them verbatim. () / -1 = not patchable (batch-local sig ids).
    group_snums: tuple = ()
    sig_epoch: int = -1
    # content-identity revision (encode_cache.next_core_rev): stamped by
    # every full _build_core, PRESERVED by try_patch (shared tables are the
    # donor's). (core_rev, table name) is the provenance token the argument
    # arena / device-conversion caches key on. -1 = no provenance.
    core_rev: int = -1
    # scheduling-class tables: priority and gang labels are INSIDE the pod
    # signature, so these are pure functions of the distinct-signature
    # sequence like every other [G] table — try_patch shares them verbatim,
    # and a priority/gang edit changes the affected snums, invalidating
    # exactly the runs it touches (encode_cache.run_identity).
    group_prio16: Optional[np.ndarray] = None  # [G] uint16 dense rank
    group_gang: Optional[np.ndarray] = None  # [G] int32 (-1 = none)
    gang_size: Optional[np.ndarray] = None  # [NG] int32
    gang_min_ranks: Optional[np.ndarray] = None  # [NG] int32
    gang_ids: Optional[List[str]] = None  # NG axis, lex order


_CORE_CACHE: Dict[tuple, tuple] = {}
_CORE_CACHE_MAX = 4


def _group_structure(pods_sorted: List[Pod], sigs: np.ndarray):
    """Group/run decomposition of an FFD-sorted pod list: per-group pod
    lists (first-appearance order), the run split, and the ordered distinct
    signature sequence. Pure NumPy except the run-slice extends."""
    n_pods = len(pods_sorted)
    if not n_pods:
        return [], np.zeros(0, np.int32), np.zeros(0, np.int32), ()
    # group ids in first-appearance order over the sorted sequence
    _, first_idx, inv = np.unique(sigs, return_index=True, return_inverse=True)
    rank = np.empty(len(first_idx), np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(first_idx))
    gids = rank[inv]
    G = len(first_idx)
    # runs: consecutive same-group stretches of the sorted pod list
    change = np.flatnonzero(np.diff(gids) != 0) + 1
    starts = np.concatenate(([0], change))
    run_group = gids[starts].astype(np.int32)
    run_count = np.diff(np.concatenate((starts, [n_pods]))).astype(np.int32)
    # per-group pod lists assembled run-by-run (S slices of the sorted
    # list, C-speed extend) — NOT via an object ndarray: numpy's
    # list→object-array fill probes every element, a cost linear in pods
    group_pods: List[List[Pod]] = [[] for _ in range(G)]
    pos = 0
    for s in range(len(run_group)):
        c = int(run_count[s])
        group_pods[int(run_group[s])].extend(pods_sorted[pos : pos + c])
        pos += c
    group_snums = tuple(int(s) for s in sigs[np.sort(first_idx)])
    return group_pods, run_group, run_count, group_snums


def _reqs_key(reqs: Requirements) -> tuple:
    return tuple(
        sorted(
            (k, r.complement, tuple(sorted(r.values)), r.greater_than,
             r.less_than, r.require_present)
            for k, r in reqs.items()
        )
    )


def _core_key(pods_f: List[Pod], inp: SolverInput) -> Tuple[tuple, np.ndarray]:
    """Cache key + the exact ordered pod-id array. The key's pod part is an
    aggregate fingerprint (fast dict hash); a hit must ALSO compare the id
    array exactly — aggregates can collide between distinct live sets. Pinning
    (group_pods in the cached core, instance types in the entry) guarantees a
    matching id refers to the same live object, never a recycled address."""
    from ..api.objects import pod_mutation_epoch

    n = len(pods_f)
    if n:
        ids = np.fromiter(map(id, pods_f), np.uint64, n)
        pod_fp = (n, int(ids.sum(dtype=np.uint64)), int(np.bitwise_xor.reduce(ids)))
    else:
        ids = np.zeros(0, np.uint64)
        pod_fp = (0, 0, 0)
    pools_key = tuple(
        (
            p.name,
            p.weight,
            _reqs_key(p.requirements),
            tuple((t.key, t.value, t.effect) for t in p.taints),
            tuple(map(id, p.instance_types)),
        )
        for p in inp.nodepools
    )
    ds_key = tuple(
        (
            tuple(sorted(dp.requests.items())),
            tuple((t.key, t.operator, t.value, t.effect) for t in dp.tolerations),
            _reqs_key(dp.scheduling_requirements()),
        )
        for dp in inp.daemonset_pods
    )
    return (
        (
            pod_mutation_epoch(),
            pod_fp,
            pools_key,
            ds_key,
            tuple(inp.zones),
            tuple(inp.capacity_types),
            inp.preference_policy,
            getattr(inp, "presorted", False),
        ),
        ids,
    )


# Catalog CONTENT fingerprint (solver/vault.py): the cache key's catalog
# segment compares instance types BY OBJECT ID (cheap, and pinned entries
# make ids safe within a process) — but ids mean nothing across a process
# boundary, so vault donors are re-keyed by this content hash instead.
# Memoized on pools_key (which embeds the type ids, so a hit proves the
# same live objects → same content) and bounded; computed only on the
# cache-INSERT path, never per solve.
_CAT_FP_CACHE: Dict[tuple, bytes] = {}
_CAT_FP_CACHE_MAX = 8


def _catalog_content_fp(pools_key: tuple, inp: SolverInput) -> bytes:
    import hashlib

    fp = _CAT_FP_CACHE.get(pools_key)
    if fp is not None:
        return fp
    parts: List[tuple] = []
    for p in inp.nodepools:
        parts.append((
            p.name,
            p.weight,
            _reqs_key(p.requirements),
            tuple((t.key, t.value, t.effect) for t in p.taints),
            tuple(
                (
                    it.name,
                    tuple(sorted(it.capacity.items())),
                    tuple(sorted(it.overhead.items())),
                    _reqs_key(it.requirements),
                    tuple(
                        sorted(
                            (o.zone, o.capacity_type, o.price, o.available)
                            for o in it.offerings
                        )
                    ),
                )
                for it in p.instance_types
            ),
        ))
    fp = hashlib.blake2b(repr(parts).encode(), digest_size=16).digest()
    if len(_CAT_FP_CACHE) >= _CAT_FP_CACHE_MAX:
        _CAT_FP_CACHE.pop(next(iter(_CAT_FP_CACHE)))
    _CAT_FP_CACHE[pools_key] = fp
    return fp


def _sig_content_seq(group_pods: List[List[Pod]]) -> tuple:
    """Ordered distinct signature CONTENT sequence of a group structure —
    the process-portable twin of group_snums (interned numbers are
    process-local; the signature tuples they intern are pure content)."""
    return tuple(_pod_signature(pl[0]) for pl in group_pods)


def encode(inp: SolverInput) -> EncodedInput:
    from . import encode_cache as ec

    tenant_id = getattr(inp, "tenant_id", None)
    pods_f = [p for p in inp.pods if not p.scheduling_gated and p.node_name is None]
    if getattr(inp, "presorted", False):
        # relax-loop encodes materialize FRESH pod objects every iteration:
        # caching them would only evict hot production cores and pin dead
        # pod lists (r5 review) — build uncached
        enc = _encode_with_nodes(_build_core(inp, pods_f), inp)
        enc.tenant_id = tenant_id
        return enc
    # tenancy: each tenant patches/evicts inside its OWN core-cache
    # namespace (solver/tenancy.py sharing boundary) — a noisy tenant can't
    # evict another tenant's hot core or donate a patch across clusters.
    # tenant_id=None keeps using the module-global _CORE_CACHE verbatim.
    cache = ec.tenant_core_cache(tenant_id, _CORE_CACHE)
    key, ids = _core_key(pods_f, inp)
    ent = cache.get(key)
    if ent is not None and np.array_equal(ids, ent[0]):
        ec.STATS["hits"] += 1
        core = ent[1]
    else:
        # delta-patch path: same sig universe + same catalog as a cached
        # core (pods added/removed within known groups) reuses every
        # group/type/pool table and rebuilds only the run split — falls
        # back to a full build for any other delta class
        presort = ffd_sort_with_sigs(pods_f, presorted=False)
        structure = _group_structure(presort[0], presort[1])
        state_rev = getattr(inp, "state_rev", None)
        cat_fp = _catalog_content_fp(key[2], inp)
        core = ec.try_patch(key, presort, structure, cache, state_rev)
        if core is not None:
            ec.STATS["patches"] += 1
        elif ec._VAULT_DONORS:
            # vault-restored donors (solver/vault.py) are keyed by CONTENT
            # — signature sequence + catalog fingerprint — so a restarted
            # process adopts its predecessor's tables instead of paying the
            # cluster-size-bounded rebuild
            core = ec.adopt_vault_donor(
                key, structure, _sig_content_seq(structure[0]), cat_fp,
                presort,
            )
            if core is not None:
                ec.STATS["vault_adopts"] += 1
        if core is None:
            core = _build_core(inp, pods_f, presort, structure)
            ec.STATS["rebuilds"] += 1
        if len(cache) >= _CORE_CACHE_MAX:
            cache.pop(next(iter(cache)))
        # entry pins the instance-type objects whose ids appear in the key
        # (pods are pinned via core.group_pods), so ids can't be recycled
        # while the entry lives
        type_pins = tuple(it for p in inp.nodepools for it in p.instance_types)
        cache[key] = (ids, core, type_pins, state_rev, cat_fp)
    enc = _encode_with_nodes(core, inp)
    enc.tenant_id = tenant_id
    return enc


def _build_core(
    inp: SolverInput,
    pods_f: List[Pod],
    presort: Optional[tuple] = None,
    structure: Optional[tuple] = None,
) -> _EncodeCore:
    # ---- axes -------------------------------------------------------------
    zones = list(inp.zones)
    cts = list(inp.capacity_types)
    pools = sorted(inp.nodepools, key=lambda p: (-p.weight, p.name))
    pool_names = [p.name for p in pools]

    # union catalog over pools, preserving first-seen (catalog) order
    type_names: List[str] = []
    types_by_name: Dict[str, object] = {}
    for p in pools:
        for it in p.instance_types:
            if it.name not in types_by_name:
                types_by_name[it.name] = it
                type_names.append(it.name)
    T = len(type_names)

    # ---- groups (vectorized: the only O(pods) work is cached-key gathering)
    if presort is None:
        presort = ffd_sort_with_sigs(
            pods_f, presorted=getattr(inp, "presorted", False)
        )
    pods_sorted, sigs, sorted_uids, sigs_interned = presort
    if structure is None:
        structure = _group_structure(pods_sorted, sigs)
    group_pods, run_group, run_count, group_snums = structure
    G = len(group_pods)

    # ---- resource axis (from group representatives — same-group pods have
    # identical requests, so the scan is O(groups), not O(pods)) -------------
    rkeys = [CPU, MEMORY, PODS]
    seen = set(rkeys)
    for pod in [pl[0] for pl in group_pods] + list(inp.daemonset_pods):
        for k, v in pod.requests.items():
            if v and k not in seen:
                seen.add(k)
                rkeys.append(k)
    R = len(rkeys)

    group_req = np.zeros((G, R), dtype=np.int32)
    for g, pl in enumerate(group_pods):
        req = Resources(pl[0].requests)
        req[PODS] = req.get_(PODS) + 1  # each pod consumes one pod slot
        group_req[g] = _quantize(req, rkeys, ceil=True)

    # representative requirement set per group (v1: single alternative)
    group_reqsets: List[Requirements] = []
    fallback = np.zeros(G, dtype=bool)
    has_topo = False
    has_aff = False
    hostname_sigs: Dict[tuple, int] = {}  # (kind, sel_sig, cap) -> q index
    zone_sigs: Dict[tuple, int] = {}  # (kind, sel_sig, cap) -> v index
    ct_sigs: Dict[tuple, int] = {}  # capacity-type-granular sigs (same shape)
    # per-group owned sigs, collected to fill v_owner / v_primary below
    group_zone_tscs: List[List[tuple]] = []
    group_zone_antis: List[List[tuple]] = []
    group_zone_affs: List[List[tuple]] = []
    group_ct_tscs: List[List[tuple]] = []
    group_ct_antis: List[List[tuple]] = []
    group_ct_affs: List[List[tuple]] = []
    group_h2: List[bool] = []  # owns a positive hostname-affinity term
    # hostname sigs OWNED per group, collected during the term scan below —
    # a term that constructs/merges a sig key is exactly what the former
    # per-sig rescan matched, so collection is the same ownership relation
    # without the O(G·Q) second pass
    group_h_owned: List[List[tuple]] = []
    respect_prefs = inp.preference_policy != "Ignore"
    for g, pl in enumerate(group_pods):
        pod = pl[0]
        h_owned: List[tuple] = []
        if len(pod.node_affinity) > 1:
            fallback[g] = True
        if respect_prefs and (
            pod.preferred_node_affinity
            or any(t.when_unsatisfiable != "DoNotSchedule" for t in pod.topology_spread)
            or any(t.weight is not None for t in pod.affinity_terms)
        ):
            # preferences relax as-required in the oracle (scheduling.md:
            # 212-219); under --preference-policy=Ignore they vanish and the
            # device path keeps the solve
            fallback[g] = True
        ztscs: List[tuple] = []
        zantis: List[tuple] = []
        zaffs: List[tuple] = []
        ctscs: List[tuple] = []
        cantis: List[tuple] = []
        caffs: List[tuple] = []
        for t in pod.topology_spread:
            if t.when_unsatisfiable != "DoNotSchedule":
                continue
            if t.topology_key == wk.HOSTNAME_LABEL:
                # closed-form on device (per-node matching-pod cap = maxSkew,
                # SPEC.md hostname floor-0 rule)
                sig = (0, tuple(sorted(t.label_selector.items())), t.max_skew)
                hostname_sigs.setdefault(sig, len(hostname_sigs))
                h_owned.append(sig)
            elif t.topology_key == wk.ZONE_LABEL:
                sig = (0, tuple(sorted(t.label_selector.items())), t.max_skew)
                zone_sigs.setdefault(sig, len(zone_sigs))
                ztscs.append(sig)
            elif t.topology_key == wk.CAPACITY_TYPE_LABEL:
                sig = (0, tuple(sorted(t.label_selector.items())), t.max_skew)
                ct_sigs.setdefault(sig, len(ct_sigs))
                ctscs.append(sig)
            else:
                has_topo = True  # custom-key spread: fallback path
        has_h2 = False
        n_h2 = 0
        for t in pod.affinity_terms:
            if t.weight is not None:
                continue
            if t.anti and t.topology_key == wk.HOSTNAME_LABEL:
                # kind 3 = admission-only (relax-materialized weighted anti):
                # same blocking allowance as kind 1, but the e_co/c_co owner
                # registrations stay kind-1-only — future members unblocked
                sig = (3 if t.admission_only else 1,
                       tuple(sorted(t.label_selector.items())), 1)
                hostname_sigs.setdefault(sig, len(hostname_sigs))
                h_owned.append(sig)
            elif t.topology_key == wk.HOSTNAME_LABEL:
                # positive hostname affinity (kind 2): per-target allowance
                # where members are present + a one-claim bootstrap budget
                # (ffd._hostname_allowance / fast())
                sig = (2, tuple(sorted(t.label_selector.items())), 0)
                hostname_sigs.setdefault(sig, len(hostname_sigs))
                h_owned.append(sig)
                has_h2 = True
                n_h2 += 1
            elif t.topology_key == wk.ZONE_LABEL:
                # kind 3 = admission-only anti (relax-materialized weighted
                # anti): blocks THIS pod's placement like a required anti but
                # never registers as an owned anti — the oracle's bookkeeping
                # records only original required terms
                kind = (3 if t.admission_only else 1) if t.anti else 2
                sig = (kind, tuple(sorted(t.label_selector.items())), 1 if t.anti else 0)
                zone_sigs.setdefault(sig, len(zone_sigs))
                (zantis if t.anti else zaffs).append(sig)
            elif t.topology_key == wk.CAPACITY_TYPE_LABEL:
                kind = (3 if t.admission_only else 1) if t.anti else 2
                sig = (kind, tuple(sorted(t.label_selector.items())), 1 if t.anti else 0)
                ct_sigs.setdefault(sig, len(ct_sigs))
                (cantis if t.anti else caffs).append(sig)
            else:
                has_aff = True  # custom-key affinity: fallback
        # the domain event engine drives ONE owned TSC and ONE positive
        # affinity per pod — including BOTH on the same pod (round 5: the
        # engine's allowed set already intersects the TSC budget with the
        # affinity present-set exactly as the oracle's sequential narrowing
        # does; parity pinned by tests/test_stacked_device.py). Multiple
        # terms of the SAME kind still fall back.
        if len(ztscs) > 1 or len(zaffs) > 1:
            fallback[g] = True
        if len(ctscs) > 1 or len(caffs) > 1:
            fallback[g] = True
        if n_h2 > 1:
            # stacked positive hostname terms: the single-target bootstrap
            # derivation only covers one term — oracle handles the corner
            fallback[g] = True
        group_zone_tscs.append(ztscs)
        group_zone_antis.append(zantis)
        group_zone_affs.append(zaffs)
        group_ct_tscs.append(ctscs)
        group_ct_antis.append(cantis)
        group_ct_affs.append(caffs)
        group_h2.append(has_h2)
        group_h_owned.append(h_owned)
        group_reqsets.append(pod.scheduling_requirements())

    # ---- domain-axis resolution -------------------------------------------
    # The V-axis event engine is domain-GENERIC: it sees only per-domain
    # column masks of the joint (zone, ct) bits, per-domain counts, and a
    # node→domain map — so capacity-type-granular constraints (the third of
    # the reference's exactly-three topology keys, scheduling.md:383-387)
    # run on the SAME engine by presenting the C axis as the domain axis.
    # A solve mixing zone- and ct-granular sigs runs with BOTH axes'
    # columns concatenated on the domain axis ("mixed"): each sig and each
    # constrained group binds to ONE axis (group_daxis), counts record per
    # axis wherever a target's domain is determined, and only pods whose
    # own constraint set genuinely spans both axes fall back.
    v_axis = "zone"
    if ct_sigs and zone_sigs:
        v_axis = "mixed"
    elif ct_sigs:
        v_axis = "ct"

    # normalize sigs to (axis, kind, sel, cap) keys; zone sigs keep their
    # indices so single-axis solves stay bit- and shape-identical
    if v_axis == "mixed":
        vsigs = {(0,) + s: i for s, i in zone_sigs.items()}
        off = len(zone_sigs)
        vsigs.update({(1,) + s: off + i for s, i in ct_sigs.items()})
        g_tscs = [
            [(0,) + s for s in group_zone_tscs[g]]
            + [(1,) + s for s in group_ct_tscs[g]]
            for g in range(G)
        ]
        g_antis = [
            [(0,) + s for s in group_zone_antis[g]]
            + [(1,) + s for s in group_ct_antis[g]]
            for g in range(G)
        ]
        g_affs = [
            [(0,) + s for s in group_zone_affs[g]]
            + [(1,) + s for s in group_ct_affs[g]]
            for g in range(G)
        ]
    elif v_axis == "ct":
        vsigs = {(0,) + s: i for s, i in ct_sigs.items()}
        g_tscs = [[(0,) + s for s in group_ct_tscs[g]] for g in range(G)]
        g_antis = [[(0,) + s for s in group_ct_antis[g]] for g in range(G)]
        g_affs = [[(0,) + s for s in group_ct_affs[g]] for g in range(G)]
    else:
        vsigs = {(0,) + s: i for s, i in zone_sigs.items()}
        g_tscs = [[(0,) + s for s in group_zone_tscs[g]] for g in range(G)]
        g_antis = [[(0,) + s for s in group_zone_antis[g]] for g in range(G)]
        g_affs = [[(0,) + s for s in group_zone_affs[g]] for g in range(G)]

    # ---- domain-sig (V axis) tables -----------------------------------------
    V = len(vsigs)
    v_member = np.zeros((G, V), dtype=bool)
    v_owner = np.zeros((G, V), dtype=bool)
    v_kind = np.zeros(V, dtype=np.int32)
    v_cap = np.zeros(V, dtype=np.int32)
    sig_axis = np.zeros(V, dtype=np.int32)
    v_primary = np.full(G, -1, dtype=np.int32)
    v_aff = np.full(G, -1, dtype=np.int32)
    group_daxis = np.zeros(G, dtype=np.int32)
    # member tables are selector-vs-representative-label verdicts: intern
    # the label dicts, evaluate once per DISTINCT (selector, label set)
    # (global cache), and gather — replaces the per-(sig, group) Python scan
    if G and (vsigs or hostname_sigs):
        rep_lids = np.fromiter(
            (_lab_id(pl[0].meta.labels) for pl in group_pods), np.int64, G
        )
        uniq_l, inv_l = np.unique(rep_lids, return_inverse=True)
    for (ax, kind, sel_sig, cap), v in vsigs.items():
        v_kind[v] = kind
        v_cap[v] = cap
        sig_axis[v] = ax
        if G:
            v_member[:, v] = _sel_verdicts(sel_sig, uniq_l)[inv_l]
    for g in range(G):
        axes = set()
        for sig in g_tscs[g]:
            v_owner[g, vsigs[sig]] = True
            v_primary[g] = vsigs[sig]
            axes.add(sig[0])
        for sig in g_antis[g]:
            v_owner[g, vsigs[sig]] = True
            axes.add(sig[0])
        for sig in g_affs[g]:
            v_owner[g, vsigs[sig]] = True
            v_aff[g] = vsigs[sig]
            axes.add(sig[0])
        # a membership in an anti sig blocks domains on that sig's axis —
        # it binds the group to the axis just like ownership does
        manti = v_member[g] & (v_kind == 1)
        if manti.any():
            axes.update(int(a) for a in sig_axis[manti])
        if len(axes) > 1:
            # genuinely two-axis pod (e.g. zone TSC + ct spread on ONE pod,
            # or zone-constrained while a ct anti selects it): the engine
            # drives one rotation state per group — oracle handles it
            fallback[g] = True
        elif axes:
            group_daxis[g] = axes.pop()
    # kind-2 hostname affinity is implemented in the FAST branch only (the
    # one-claim bootstrap budget is not threaded through the zoned event
    # engine's open paths): a group owning one that is ALSO domain-
    # constrained (owns V sigs or is a member of a domain anti — either
    # routes it to the zoned branch) falls back
    for g in range(G):
        if group_h2[g] and (
            v_owner[g].any() or (v_member[g] & (v_kind == 1)).any()
        ):
            fallback[g] = True

    Q = len(hostname_sigs)
    q_member = np.zeros((G, Q), dtype=bool)
    q_owner = np.zeros((G, Q), dtype=bool)
    q_kind = np.zeros(Q, dtype=np.int32)
    q_cap = np.ones(Q, dtype=np.int32)
    for (kind, sel_sig, cap), q in hostname_sigs.items():
        q_kind[q] = kind
        q_cap[q] = cap
        if G:
            q_member[:, q] = _sel_verdicts(sel_sig, uniq_l)[inv_l]
    # ownership collected during the term scan: a group owns exactly the
    # sigs its representative's terms constructed (the sig key encodes
    # kind/selector/cap, so key identity IS the former rescan's match)
    for g, owned in enumerate(group_h_owned):
        for s in owned:
            q_owner[g, hostname_sigs[s]] = True

    # ---- instance-type tensors ---------------------------------------------
    type_alloc = np.zeros((T, R), dtype=np.int32)
    type_capacity = np.zeros((T, R), dtype=np.int32)
    offer_avail = np.zeros((T, len(zones), len(cts)), dtype=bool)
    offer_price = np.full((T, len(zones), len(cts)), np.inf, dtype=np.float32)
    zid = {z: i for i, z in enumerate(zones)}
    cid = {c: i for i, c in enumerate(cts)}
    rkeys_tuple = tuple(rkeys)
    if len(_TYPE_ROW_CACHE) > 8192:
        # catalog churn (e.g. ICE-seq rebuilds) creates fresh type objects;
        # bound the id-keyed cache so stale generations don't accumulate
        _TYPE_ROW_CACHE.clear()
    for t, name in enumerate(type_names):
        it = types_by_name[name]
        # alloc = floor(capacity) - ceil(overhead): matches quantize_input's
        # per-field rounding exactly (allocatable() of quantized fields).
        # Rows cache per (type object, resource axis) — the catalog is static
        # across solves, so steady state is a dict hit per type.
        ent = _TYPE_ROW_CACHE.get(id(it))
        if ent is not None and ent[0] is it and ent[1] == rkeys_tuple:
            type_alloc[t], type_capacity[t] = ent[2], ent[3]
        else:
            cap_q = np.asarray(_quantize(it.capacity, rkeys, ceil=False), dtype=np.int64)
            ovh_q = np.asarray(_quantize(it.overhead, rkeys, ceil=True), dtype=np.int64)
            alloc_row = np.maximum(cap_q - ovh_q, 0).astype(np.int32)
            cap_row = cap_q.astype(np.int32)
            type_alloc[t], type_capacity[t] = alloc_row, cap_row
            _TYPE_ROW_CACHE[id(it)] = (it, rkeys_tuple, alloc_row, cap_row)
        for o in it.offerings:
            if o.zone in zid and o.capacity_type in cid:
                zi, ci = zid[o.zone], cid[o.capacity_type]
                if o.available:
                    offer_avail[t, zi, ci] = True
                    offer_price[t, zi, ci] = min(offer_price[t, zi, ci], o.price)

    # ---- group×type / group×zone / group×ct --------------------------------
    # group×type compatibility rows cache by interned pod signature id: a
    # recurring group (same deployment, next solve) costs a dict hit instead
    # of T requirement-algebra calls. The catalog is identified by object ids,
    # with the referenced types pinned in the cache entry so ids can't be
    # recycled under us; the epoch in the key invalidates entries when the
    # signature intern table resets.
    types_tuple = tuple(types_by_name[n] for n in type_names)
    types_ids = tuple(map(id, types_tuple))
    group_compat_t = np.zeros((G, T), dtype=bool)
    group_zone = np.zeros((G, len(zones)), dtype=bool)
    group_ct = np.zeros((G, len(cts)), dtype=bool)
    if len(_GROUP_COMPAT_CACHE) > 8192:
        _GROUP_COMPAT_CACHE.clear()
    for g, reqs in enumerate(group_reqsets):
        zr = reqs.get(wk.ZONE_LABEL)
        for i, z in enumerate(zones):
            group_zone[g, i] = zr is None or zr.has(z)
        cr = reqs.get(wk.CAPACITY_TYPE_LABEL)
        for i, c in enumerate(cts):
            group_ct[g, i] = cr is None or cr.has(c)
        key = (_SIG_EPOCH, group_snums[g]) if sigs_interned else None
        ent = _GROUP_COMPAT_CACHE.get(key) if key is not None else None
        if ent is not None and ent[0] == types_ids:
            group_compat_t[g] = ent[2]
        else:
            row = np.fromiter(
                (reqs.compatible(it.requirements) for it in types_tuple),
                dtype=bool,
                count=T,
            )
            group_compat_t[g] = row
            if key is not None:
                _GROUP_COMPAT_CACHE[key] = (types_ids, types_tuple, row)

    # ---- pool tensors (usage/limits are per-solve: _encode_with_nodes) -----
    P = len(pools)
    pool_type = np.zeros((P, T), dtype=bool)
    pool_zone = np.zeros((P, len(zones)), dtype=bool)
    pool_ct = np.zeros((P, len(cts)), dtype=bool)
    pool_daemon = np.zeros((P, R), dtype=np.int32)
    group_pool = np.zeros((G, P), dtype=bool)
    for p, pool in enumerate(pools):
        in_pool = {it.name for it in pool.instance_types}
        zr = pool.requirements.get(wk.ZONE_LABEL)
        for i, z in enumerate(zones):
            pool_zone[p, i] = zr is None or zr.has(z)
        cr = pool.requirements.get(wk.CAPACITY_TYPE_LABEL)
        for i, c in enumerate(cts):
            pool_ct[p, i] = cr is None or cr.has(c)
        for t, name in enumerate(type_names):
            if name not in in_pool:
                continue
            it = types_by_name[name]
            if not pool.requirements.compatible(it.requirements):
                continue
            # needs ≥1 available offering within pool zone/ct masks
            ok = (offer_avail[t] & pool_zone[p][:, None] & pool_ct[p][None, :]).any()
            pool_type[p, t] = ok
        # daemonset overhead (SPEC: daemonsets admitted by pool requirements)
        dres = Resources()
        dcount = 0
        for dp in inp.daemonset_pods:
            if not tolerates_all(dp.tolerations, pool.taints):
                continue
            if not dp.scheduling_requirements().compatible(pool.requirements):
                continue
            dres = dres.add(dp.requests)
            dcount += 1
        dres[PODS] = dres.get_(PODS) + dcount
        pool_daemon[p] = _quantize(dres, rkeys, ceil=True)
        for g, pl in enumerate(group_pods):
            pod = pl[0]
            if not tolerates_all(pod.tolerations, pool.taints):
                continue
            group_pool[g, p] = group_reqsets[g].compatible(pool.requirements)

    # ---- pairwise group compatibility --------------------------------------
    # compatible() is pure requirement algebra, so dedupe by DISTINCT
    # requirement-set content: D distinct sets cost D·(D+1)/2 calls instead
    # of G·(G-1)/2 (the s-stress shape — thousands of groups, one distinct
    # reqset — collapses to a single call), then gather to [G, G]. The
    # diagonal is forced True afterwards exactly as the original never
    # computed it (a self-incompatible reqset still pairs False off-diagonal).
    uniq_req: Dict[tuple, int] = {}
    req_rep_idx = np.fromiter(
        (uniq_req.setdefault(_reqs_key(r), len(uniq_req)) for r in group_reqsets),
        np.int64,
        G,
    )
    Dreq = len(uniq_req)
    rep_reqs: List[Optional[Requirements]] = [None] * Dreq
    for g in range(G):
        if rep_reqs[req_rep_idx[g]] is None:
            rep_reqs[req_rep_idx[g]] = group_reqsets[g]
    rep_pair = np.ones((Dreq, Dreq), dtype=bool)
    for a in range(Dreq):
        for b in range(a, Dreq):
            ok = rep_reqs[a].compatible(rep_reqs[b])
            rep_pair[a, b] = rep_pair[b, a] = ok
    group_pair = rep_pair[np.ix_(req_rep_idx, req_rep_idx)]
    np.fill_diagonal(group_pair, True)
    # ≥3-way custom-label joint conflicts the pairwise mask can't see:
    # detect custom keys with ≥3 distinct finite value-sets among groups.
    custom_sets: Dict[str, set] = {}
    tracked = {wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL, wk.INSTANCE_TYPE_LABEL}
    for reqs in group_reqsets:
        for k, r in reqs.items():
            if k in tracked or r.complement:
                continue
            custom_sets.setdefault(k, set()).add(tuple(sorted(r.values)))
    for k, vsets in custom_sets.items():
        if len(vsets) >= 3:
            for g, reqs in enumerate(group_reqsets):
                if k in reqs:
                    fallback[g] = True

    # ---- scheduling-class tables (priority ranks + gang membership) --------
    # Group representatives are exact: priority and the gang labels ride the
    # pod signature, so every pod in a group agrees on them.
    n_groups = len(group_pods)
    g_prios = np.fromiter((gp[0].priority for gp in group_pods), np.int64,
                          n_groups)
    group_prio16 = np.searchsorted(np.unique(g_prios), g_prios).astype(np.uint16)
    g_gangs = [gp[0].gang() for gp in group_pods]
    gang_ids = sorted({g[0] for g in g_gangs if g is not None})
    gang_rank = {gid: i for i, gid in enumerate(gang_ids)}
    group_gang = np.fromiter(
        (gang_rank[g[0]] if g is not None else -1 for g in g_gangs),
        np.int32, n_groups,
    )
    # a gang id declared with conflicting size/min-ranks across groups takes
    # the MAX of each (conservative: harder to commit, never a partial gang)
    gang_size = np.zeros(len(gang_ids), np.int32)
    gang_min_ranks = np.zeros(len(gang_ids), np.int32)
    for g in g_gangs:
        if g is None:
            continue
        i = gang_rank[g[0]]
        gang_size[i] = max(gang_size[i], g[1])
        gang_min_ranks[i] = max(gang_min_ranks[i], g[2])
    gang_min_ranks = np.minimum(gang_min_ranks, gang_size)

    return _EncodeCore(
        zones=zones,
        cts=cts,
        type_names=type_names,
        pool_names=pool_names,
        rkeys=rkeys,
        charge_axes=np.asarray([k in (CPU, MEMORY) for k in rkeys], dtype=bool),
        group_pods=group_pods,
        group_req=group_req,
        group_compat_t=group_compat_t,
        group_zone=group_zone,
        group_ct=group_ct,
        group_pool=group_pool,
        group_pair=group_pair,
        fallback=fallback,
        run_group=np.asarray(run_group, dtype=np.int32),
        run_count=np.asarray(run_count, dtype=np.int32),
        sorted_uids=sorted_uids,
        group_reqsets=group_reqsets,
        has_topo=has_topo,
        has_aff=has_aff,
        hostname_sigs=hostname_sigs,
        zone_sigs=vsigs,
        v_axis=v_axis,
        sig_axis=sig_axis,
        group_daxis=group_daxis,
        q_member=q_member,
        q_owner=q_owner,
        q_kind=q_kind,
        q_cap=q_cap,
        v_member=v_member,
        v_owner=v_owner,
        v_kind=v_kind,
        v_cap=v_cap,
        v_primary=v_primary,
        v_aff=v_aff,
        type_alloc=type_alloc,
        type_capacity=type_capacity,
        offer_avail=offer_avail,
        offer_price=offer_price,
        pool_type=pool_type,
        pool_zone=pool_zone,
        pool_ct=pool_ct,
        pool_daemon=pool_daemon,
        all_req_keys=sorted({k for reqs in group_reqsets for k in reqs}),
        zid=zid,
        cid=cid,
        group_snums=group_snums if sigs_interned else (),
        sig_epoch=_SIG_EPOCH if sigs_interned else -1,
        core_rev=_fresh_core_rev(),
        group_prio16=group_prio16,
        group_gang=group_gang,
        gang_size=gang_size,
        gang_min_ranks=gang_min_ranks,
        gang_ids=gang_ids,
    )


def _fresh_core_rev() -> int:
    from . import encode_cache as ec

    return ec.next_core_rev()


def _encode_with_nodes(core: _EncodeCore, inp: SolverInput) -> EncodedInput:
    """Per-solve stage: existing-node tensors + pool usage/limits (both
    change between solves) assembled around the cached core."""
    zones, cts, rkeys = core.zones, core.cts, core.rkeys
    group_pods, group_reqsets = core.group_pods, core.group_reqsets
    hostname_sigs, zone_sigs = core.hostname_sigs, core.zone_sigs
    zid, cid = core.zid, core.cid
    G = len(group_pods)
    R = len(rkeys)
    Q = len(hostname_sigs)
    V = len(zone_sigs)
    has_topo = core.has_topo

    # pool usage/limits from the fresh pool objects, in core's pool order
    pools = sorted(inp.nodepools, key=lambda p: (-p.weight, p.name))
    P = len(pools)
    pool_limit = np.full((P, R), INT32_MAX, dtype=np.int32)
    pool_usage = np.zeros((P, R), dtype=np.int32)
    for p, pool in enumerate(pools):
        for i, k in enumerate(rkeys):
            if k in pool.limits:
                pool_limit[p, i] = min(int(pool.limits[k]), int(INT32_MAX))
        pool_usage[p] = _quantize(pool.usage, rkeys, ceil=True)

    # ---- existing nodes -----------------------------------------------------
    E = len(inp.nodes)
    node_free = np.zeros((E, R), dtype=np.int32)
    node_compat = np.zeros((G, E), dtype=bool)
    node_zone = np.full(E, -1, dtype=np.int32)
    node_ct = np.full(E, -1, dtype=np.int32)
    node_ids = [n.id for n in inp.nodes]
    node_q_member = np.zeros((E, Q), dtype=np.int32)
    node_q_owner = np.zeros((E, Q), dtype=np.int32)  # unknowable from labels
    sig_list = sorted(hostname_sigs.items(), key=lambda kv: kv[1])
    if Q:
        # The device Q axis treats each node ROW as one hostname domain; if
        # two nodes share a kubernetes.io/hostname label they are ONE domain
        # per SPEC.md, which the per-row counts can't express — fallback.
        from ..provisioning.scheduler import node_hostname

        hostnames = [node_hostname(n) for n in inp.nodes]
        if len(set(hostnames)) < len(hostnames):
            has_topo = True
    # domain axis for the V sigs: zone (default), capacity-type, or BOTH
    # concatenated ("mixed": zone columns then lex-ordered ct columns) — the
    # engine's index-order tiebreaks must match the oracle's string-lex
    # domain tiebreaks (scheduler._affinity_admits / commit rules)
    ct_lex = sorted(cts)
    ct_rank = {c: i for i, c in enumerate(ct_lex)}
    Zc = len(zones)
    if core.v_axis == "ct":
        v_domains = ct_lex
        dom_rank = dict(ct_rank)
        node_domain_of = lambda n: dom_rank.get(
            n.labels.get(wk.CAPACITY_TYPE_LABEL, ""), -1
        )
    elif core.v_axis == "mixed":
        v_domains = list(zones) + ct_lex
        dom_rank = {z: i for i, z in enumerate(zones)}
        node_domain_of = lambda n: dom_rank.get(n.labels.get(wk.ZONE_LABEL, ""), -1)
    else:
        v_domains = list(zones)
        dom_rank = {z: i for i, z in enumerate(v_domains)}
        node_domain_of = lambda n: dom_rank.get(n.labels.get(wk.ZONE_LABEL, ""), -1)
    v_node_domain = np.full(E, -1, dtype=np.int32)
    # second-axis column per node (mixed only): Z + lex rank of its ct
    node_dom2 = np.full(E, -1, dtype=np.int32)
    v_count0 = np.zeros((V, len(v_domains)), dtype=np.int32)
    node_v_member = np.zeros((E, V), dtype=np.int32)
    zsig_list = sorted(zone_sigs.items(), key=lambda kv: kv[1])
    all_req_keys = core.all_req_keys
    profile_cols: Dict[tuple, np.ndarray] = {}
    if E:
        # node_free in one pass: gather raw values, then vectorized MiB
        # floor on memory-like columns / truncation elsewhere — identical
        # to per-node _quantize(ceil=False)
        raw = np.fromiter(
            (n.free.get_(k) for n in inp.nodes for k in rkeys),
            np.float64,
            E * R,
        ).reshape(E, R)
        mib_cols = np.asarray([k in _MIB_KEYS for k in rkeys])
        qv = np.where(mib_cols[None, :], np.floor_divide(raw, MIB), np.trunc(raw))
        node_free = np.minimum(qv, float(INT32_MAX)).astype(np.int32)
    for e, n in enumerate(inp.nodes):
        node_zone[e] = zid.get(n.labels.get(wk.ZONE_LABEL, ""), -1)
        node_ct[e] = cid.get(n.labels.get(wk.CAPACITY_TYPE_LABEL, ""), -1)
        v_node_domain[e] = node_domain_of(n)
        if core.v_axis == "mixed":
            cr = ct_rank.get(n.labels.get(wk.CAPACITY_TYPE_LABEL, ""), -1)
            node_dom2[e] = Zc + cr if cr >= 0 else -1
    # Q/V bound-pod counts: intern every bound pod's label dict, evaluate
    # each selector once per DISTINCT label set (global verdict cache), and
    # scatter per-node counts — replaces the former O(E · (Q+V) · pods)
    # per-node Python scans with O(distinct labels · sigs) verdicts plus
    # vectorized bincounts.
    if (Q or V) and E:
        pod_lids = [
            np.fromiter(
                (_lab_id(pl) for pl in n.pod_labels), np.int64, len(n.pod_labels)
            )
            for n in inp.nodes
        ]
        lens = np.fromiter((len(a) for a in pod_lids), np.int64, E)
        if lens.sum():
            lids_all = np.concatenate(pod_lids)
            nidx = np.repeat(np.arange(E), lens)
            uniq_n, inv_n = np.unique(lids_all, return_inverse=True)
            for (kind, sel_sig, cap), q in sig_list:
                hit = _sel_verdicts(sel_sig, uniq_n)[inv_n]
                node_q_member[:, q] = np.bincount(nidx[hit], minlength=E)
            if V:
                # only nodes with a determined domain contribute (and
                # record) member counts — undetermined rows stay zero,
                # matching the oracle's "placement records every known
                # topology key" rule
                det = (v_node_domain >= 0) | (node_dom2 >= 0)
                for (ax, kind, sel_sig, cap), v in zsig_list:
                    hit = _sel_verdicts(sel_sig, uniq_n)[inv_n]
                    cnts = np.bincount(nidx[hit], minlength=E)
                    cnts[~det] = 0
                    node_v_member[:, v] = cnts
                m1 = v_node_domain >= 0
                if m1.any():
                    np.add.at(v_count0.T, v_node_domain[m1], node_v_member[m1])
                m2 = node_dom2 >= 0
                if m2.any():
                    np.add.at(v_count0.T, node_dom2[m2], node_v_member[m2])
    for e, n in enumerate(inp.nodes):
        if not n.schedulable:
            continue
        # Node-profile dedupe: strictly_compatible only reads the labels at
        # the groups' requirement keys, and toleration checks only read
        # taints — so nodes sharing (taints, referenced-label values) share
        # the whole [G] compat column. A homogeneous fleet computes G×profiles
        # algebra calls instead of G×E.
        prof = (
            tuple((t.key, t.value, t.effect) for t in n.taints),
            tuple(n.labels.get(k) for k in all_req_keys),
        )
        col = profile_cols.get(prof)
        if col is None:
            node_reqs = Requirements.from_labels(n.labels)
            col = np.fromiter(
                (
                    tolerates_all(group_pods[g][0].tolerations, n.taints)
                    and group_reqsets[g].strictly_compatible(node_reqs)
                    for g in range(G)
                ),
                bool,
                G,
            )
            profile_cols[prof] = col
        node_compat[:, e] = col

    return EncodedInput(
        resource_keys=rkeys,
        zones=zones,
        capacity_types=cts,
        type_names=core.type_names,
        pool_names=core.pool_names,
        group_pods=group_pods,
        group_req=core.group_req,
        group_compat_t=core.group_compat_t,
        group_zone=core.group_zone,
        group_ct=core.group_ct,
        group_pool=core.group_pool,
        group_pair=core.group_pair,
        group_fallback=core.fallback,
        run_group=core.run_group,
        run_count=core.run_count,
        sorted_uids=core.sorted_uids,
        type_alloc=core.type_alloc,
        type_capacity=core.type_capacity,
        charge_axes=core.charge_axes,
        offer_avail=core.offer_avail,
        offer_price=core.offer_price,
        pool_type=core.pool_type,
        pool_zone=core.pool_zone,
        pool_ct=core.pool_ct,
        pool_daemon=core.pool_daemon,
        pool_limit=pool_limit,
        pool_usage=pool_usage,
        node_free=node_free,
        node_compat=node_compat,
        node_zone=node_zone,
        node_ct=node_ct,
        node_ids=node_ids,
        has_topology=has_topo,
        has_affinity=core.has_aff,
        q_member=core.q_member,
        q_owner=core.q_owner,
        q_kind=core.q_kind,
        q_cap=core.q_cap,
        node_q_member=node_q_member,
        node_q_owner=node_q_owner,
        v_member=core.v_member,
        v_owner=core.v_owner,
        v_kind=core.v_kind,
        v_cap=core.v_cap,
        v_primary=core.v_primary,
        v_aff=core.v_aff,
        v_count0=v_count0,
        node_v_member=node_v_member,
        v_axis=core.v_axis,
        v_domains=v_domains,
        v_node_domain=v_node_domain,
        sig_axis=core.sig_axis,
        group_daxis=core.group_daxis,
        node_dom2=node_dom2,
        core_rev=core.core_rev,
        group_snums=core.group_snums,
        run_prio16=(
            core.group_prio16[core.run_group]
            if core.group_prio16 is not None else None
        ),
        run_gang=(
            core.group_gang[core.run_group]
            if core.group_gang is not None else None
        ),
        gang_size=core.gang_size,
        gang_min_ranks=core.gang_min_ranks,
        gang_ids=core.gang_ids,
    )


# ---------------------------------------------------------------------------
# Sparse constraint tables (compacted V/Q-axis evaluation)
# ---------------------------------------------------------------------------
#
# The dense kernel charges every run full Q/V width even when its group
# touches a handful of sigs. These run-major index tables list, per run,
# exactly the constraint sigs its group is member or owner of (-1 padded
# to a quantum-bucketed width), and the sparse kernel entry points
# (cuda/ffd.SPARSE_ARG_SPEC) gather only those columns. Because the kernel
# re-gathers the membership flags through the index, any SUPERSET list is
# decision-identical — which is what makes the ladder union and the
# density gate free to be approximate about WIDTH, never about membership.

SPARSE_IDX_MULT = 8  # quantum bucket for the per-run index-list width
SPARSE_IDX_FLOOR = 8
SPARSE_MIN_SIGS = 8  # combined Q+V width below which dense is already fine
SPARSE_DENSITY_MAX = 0.25  # gate: active (run, sig) fraction


def _sparse_width(n: int) -> int:
    """Bucket an index-list width so compile buckets stay shared."""
    return max(
        SPARSE_IDX_FLOOR,
        ((n + SPARSE_IDX_MULT - 1) // SPARSE_IDX_MULT) * SPARSE_IDX_MULT,
    )


def constraint_density(enc: "EncodedInput") -> float:
    """Fraction of (run, sig) pairs that are active — the quantity the
    sparse engine makes the kernel pay for, replacing the flat V/Q factors
    in the cost model."""
    Q, V = enc.Q, enc.V
    S = int(len(enc.run_group))
    if Q + V == 0 or S == 0:
        return 0.0
    rg = np.asarray(enc.run_group, np.int64)
    nnz = 0
    if Q:
        act_q = np.asarray(enc.q_member, bool) | np.asarray(enc.q_owner, bool)
        nnz += int(act_q[rg].sum())
    if V:
        act_v = np.asarray(enc.v_member, bool) | np.asarray(enc.v_owner, bool)
        nnz += int(act_v[rg].sum())
    return nnz / float(S * (Q + V))


def use_sparse_constraints(enc: "EncodedInput") -> bool:
    """Density gate between the dense tables and the compacted form: sparse
    wins when the sig axes are wide enough to charge real rent AND most
    (run, sig) pairs are inactive. Both thresholds are deliberately plain
    constants — the boundary is pinned by tests, not tuned per fleet."""
    if enc.Q + enc.V < SPARSE_MIN_SIGS:
        return False
    return constraint_density(enc) <= SPARSE_DENSITY_MAX


def _sparse_axis_table(act, rg, Sp, run_ladder):
    """One axis's run-major index table: [Sp, K] i32, -1 padded, where row
    s lists the active sig indices of run s's group (unioned over rung
    groups in ladder mode). Vectorized CSR-style fill: np.nonzero walks
    row-major, so each hit's rank within its row is its column slot."""
    S = rg.shape[0]
    run_act = act[rg]  # [S, X]
    if run_ladder is not None:
        lad = np.asarray(run_ladder, np.int64)
        for j in range(lad.shape[1]):
            gv = lad[:, j]
            ok = gv >= 0
            if ok.any():
                run_act[ok] |= act[gv[ok]]
    counts = run_act.sum(axis=1)
    K = _sparse_width(int(counts.max(initial=0)))
    out = np.full((Sp, K), -1, np.int32)
    rows, cols = np.nonzero(run_act)
    if rows.size:
        starts = np.searchsorted(rows, np.arange(S))
        pos = np.arange(rows.size) - starts[rows]
        out[rows, pos] = cols
    return out


def sparse_run_tables(enc: "EncodedInput", Sp: int, run_ladder=None):
    """Build the compacted constraint tables (cuda/ffd.SPARSE_ARG_SPEC):
    (run_q_idx [Sp, Kq] i32, run_v_idx [Sp, Kv] i32). `Sp` is the padded
    run-axis width (padding rows are all -1 = no active sigs, matching the
    padded runs' count==0 skip). In ladder mode each row is the union over
    the run's base group and every materialized rung group, so one gathered
    view covers the whole cascade."""
    rg = np.asarray(enc.run_group, np.int64)
    if enc.Q:
        act_q = np.asarray(enc.q_member, bool) | np.asarray(enc.q_owner, bool)
        run_q_idx = _sparse_axis_table(act_q, rg, Sp, run_ladder)
    else:
        run_q_idx = np.full((Sp, SPARSE_IDX_FLOOR), -1, np.int32)
    if enc.V:
        act_v = np.asarray(enc.v_member, bool) | np.asarray(enc.v_owner, bool)
        run_v_idx = _sparse_axis_table(act_v, rg, Sp, run_ladder)
    else:
        run_v_idx = np.full((Sp, SPARSE_IDX_FLOOR), -1, np.int32)
    return run_q_idx, run_v_idx


# (id(group_pods), core_rev) -> (group_topo, group_aff); tiny bounded memo
# for the O(pods) flags walk below. id() alone is NOT a safe key — CPython
# recycles addresses after GC — but a recycled address cannot arrive with
# the SAME core_rev: a fresh group_pods list exists only on a fresh core
# build, which stamps a fresh monotone rev (encode_cache.next_core_rev),
# while delta-patched copies share BOTH the list identity and the donor's
# rev. The pair is therefore collision-free without pinning pod lists
# alive.
_EXPLAIN_FLAGS_CACHE: dict = {}


def explain_tables(enc: EncodedInput) -> dict:
    """The EXPLAIN side-kernel inputs (cuda/ffd.py EXPLAIN_ARG_SPEC minus the
    scan-owned take_e and the padding scalars), unpadded — the encoder
    already owns every one of these tensors, so the explain path adds no
    new object walks beyond the per-group engine flags. Shared verbatim by
    the device kernel dispatch (backend) and the host deriver
    (obs/explain.host_table), which is what makes their outputs
    bit-comparable.

    The per-group engine-flags walk is O(pods), too hot to repeat per
    solve: the flags memoize keyed on
    (identity of enc.group_pods, enc.core_rev) — delta-patched enc copies
    share both by reference (dataclasses.replace keeps field refs), so
    warm solves hit, while an id() recycled by GC always carries a fresh
    core_rev and misses. Hand-built encs without a stamped rev (< 0) are
    computed fresh and never cached. The cheap array dict is rebuilt from
    the current enc every call because node tables DO change across
    patches."""
    gp = enc.group_pods
    ckey = (id(gp), enc.core_rev)
    hit = _EXPLAIN_FLAGS_CACHE.get(ckey) if enc.core_rev >= 0 else None
    if hit is not None:
        group_topo, group_aff = hit
    else:
        G = int(enc.group_req.shape[0])
        group_topo = np.zeros(G, dtype=bool)
        group_aff = np.zeros(G, dtype=bool)
        for g in range(G):
            topo = aff = False
            for p in gp[g]:
                topo = topo or bool(getattr(p, "topology_spread", None))
                aff = aff or bool(getattr(p, "affinity_terms", None))
                if topo and aff:
                    break
            group_topo[g] = topo
            group_aff[g] = aff
        if enc.core_rev >= 0:
            if len(_EXPLAIN_FLAGS_CACHE) >= 8:
                _EXPLAIN_FLAGS_CACHE.pop(next(iter(_EXPLAIN_FLAGS_CACHE)))
            _EXPLAIN_FLAGS_CACHE[ckey] = (group_topo, group_aff)
    return {
        "run_group": enc.run_group,
        "group_req": enc.group_req,
        "node_free": enc.node_free,
        "node_compat": enc.node_compat,
        "node_zone": enc.node_zone,
        "node_ct": enc.node_ct,
        "group_zone": enc.group_zone,
        "group_ct": enc.group_ct,
        "group_topo": group_topo,
        "group_aff": group_aff,
    }
