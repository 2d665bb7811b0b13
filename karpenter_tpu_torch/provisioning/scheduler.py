# Port copy of karpenter_tpu/provisioning/scheduler.py (cut to the solver seam's types, the FFD order and the minValues rule; the oracle Scheduler is not ported).
"""Reference scheduler: exact, sequential implementation of solver/SPEC.md.

This is the ground-truth `Solver` — the behavioral mirror of karpenter core's
`provisioning/scheduling.Scheduler.Solve` (designs/bin-packing.md:17-43;
website/.../concepts/scheduling.md; SURVEY.md §2.1). The TPU tensor solver in
`karpenter_tpu/solver/tpu/` must produce bit-identical decisions; the
differential tests enforce it.

Everything here is integer-exact and deterministic per SPEC.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import wellknown as wk
from ..api.objects import Pod, Taint
from ..cloudprovider.types import InstanceType
from ..scheduling.requirements import Requirements
from ..utils.resources import Resources


# ---------------------------------------------------------------------------
# Inputs / outputs
# ---------------------------------------------------------------------------


@dataclass
class BoundPodRef:
    """Preemption-relevant view of one bound pod: enough to plan an eviction
    (who, how important, how much capacity it returns) without carrying the
    Pod object into the solver."""

    uid: str
    priority: int
    requests: Resources
    # False for pods the preemption planner must never evict: do-not-disrupt
    # annotated, DaemonSet-owned, or already terminating.
    evictable: bool = True


@dataclass
class ExistingNode:
    """A schedulable existing node or in-flight NodeClaim."""

    id: str
    labels: Dict[str, str]
    taints: List[Taint]
    free: Resources  # allocatable minus bound pods/daemonsets
    pod_labels: List[Dict[str, str]] = field(default_factory=list)  # bound pods (for topo/affinity)
    schedulable: bool = True
    # bound-pod refs for the preemption planner (solver/scheduling_class.py);
    # empty is always safe — the node simply offers no reclaimable capacity
    bound_pods: List[BoundPodRef] = field(default_factory=list)


@dataclass
class NodePoolSpec:
    name: str
    weight: int
    requirements: Requirements  # template labels+requirements (+nodepool label)
    taints: List[Taint]
    instance_types: List[InstanceType]
    limits: Resources = field(default_factory=Resources)
    usage: Resources = field(default_factory=Resources)  # current aggregate
    # per-pool backend override (wellknown.SOLVER_BACKEND_LABEL); None =
    # operator default. Consulted only by the ConvexSolver selection gate —
    # the FFD kernel and the oracle never read it.
    solver_backend: Optional[str] = None


@dataclass
class SolverInput:
    pods: List[Pod]
    nodes: List[ExistingNode]
    nodepools: List[NodePoolSpec]
    daemonset_pods: List[Pod] = field(default_factory=list)
    zones: Tuple[str, ...] = ()  # zone universe (for topology domains)
    capacity_types: Tuple[str, ...] = (wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_SPOT)
    # --preference-policy (settings.md:38): Respect treats preferences as
    # required and relaxes them by ascending weight on failure; Ignore drops
    # every preference up front.
    preference_policy: str = "Respect"
    # pods are ALREADY in canonical FFD order — skip the sort. Set only by
    # the device relaxation loop (solver/relax.py), which must keep the
    # ORIGINAL pods' processing order while pods' materialized signatures
    # change between redispatches.
    presorted: bool = False
    # Encode-cache delta stamp (state/cluster.py:EncodeDeltas.snapshot()):
    # (tracker identity, catalog rev, pods rev, nodes rev). Optional hint —
    # a matching tracker + catalog rev lets the incremental encoder skip the
    # deep catalog-key compare when hunting a patch donor (solver/
    # encode_cache.py); None is always safe (full compare).
    state_rev: Optional[tuple] = None
    # Tenancy attribution (solver/tenancy.py): which tenant's cluster this
    # snapshot belongs to. Never consulted by the solving math — it selects
    # the per-tenant encode-cache namespace and arena residency namespace,
    # and rides into span attrs / flight dumps / JSON logs. None = the
    # single-tenant default namespace (byte-identical to pre-tenancy).
    tenant_id: Optional[str] = None


@dataclass
class ClaimResult:
    nodepool: str
    requirements: Requirements
    instance_type_names: List[str]
    pod_uids: List[str]
    requests: Resources
    taints: List[Taint]
    hostname: str


@dataclass
class Eviction:
    """One planned preemption: evict `pod_uid` (bound on `node_id`) so the
    strictly-higher-priority pending pod `for_pod` can land there on a later
    reconcile. The solver plans; provisioning/preemption.py executes."""

    node_id: str
    pod_uid: str
    victim_priority: int
    for_pod: str


@dataclass
class SolverResult:
    placements: Dict[str, Tuple[str, object]]  # pod uid -> ("node", id) | ("claim", idx)
    claims: List[ClaimResult]
    errors: Dict[str, str]
    # scheduling-class outputs (solver/scheduling_class.py); default-empty so
    # every pre-existing constructor call and consumer stays valid
    evictions: List[Eviction] = field(default_factory=list)
    gangs_unschedulable: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# FFD order (SPEC.md "Pod order")
# ---------------------------------------------------------------------------


def ffd_key(pod: Pod):
    # cached on the pod: sort keys are an O(pods·log pods) Python cost per
    # solve; pods are immutable once admitted (objects are replaced on
    # update), so the key survives across solves like the encoder signature
    k = pod.__dict__.get("_ffd_key")
    if k is None:
        k = (-pod.requests.get_("cpu"), -pod.requests.get_("memory"), pod.meta.uid)
        pod.__dict__["_ffd_key"] = k
    return k


def ffd_sort(pods: Sequence[Pod]) -> List[Pod]:
    """Canonical FFD order (SPEC.md "Pod order"): descending (cpu, memory);
    within an equal-size block, same-signature pods group contiguously by
    first appearance (uid order within a signature). Size ties are arbitrary
    for FFD correctness — grouping them maximizes run length so the tensor
    path scans O(distinct specs) steps instead of O(pods) when differently-
    constrained pods interleave by uid.

    Scheduling classes (SPEC.md "Priority, preemption & gang semantics")
    prepend two keys — priority descending, then gang id lexicographic
    (non-gang pods carry "" and sort first within a priority) — but ONLY
    when the batch actually carries more than one distinct priority or any
    gang. A flat fleet takes the exact pre-class code path, so the class
    machinery is provably inert there (the lexsort keys would be constant
    anyway; skipping them keeps even the float of the key-build identical).

    Vectorized (numpy lexsort + stable regroup): the per-solve sort is an
    O(pods) host cost on the end-to-end Solve() seam, so no Python-level
    comparison runs; semantics are identical to the sequential spec above
    (tests/test_solver_parity.py covers the interleaved-tie cases)."""
    return ffd_sort_with_sigs(pods)[0]


def _class_keys(pods: Sequence[Pod]):
    """(neg_prio[int64], gang_rank[int64]) when class-aware ordering must
    engage, else None. Gang ranks are the lexicographic ranks of the gang-id
    strings with "" (no gang) ranked 0, so ascending rank == ascending lex
    order and non-gang pods precede gangs within a priority level."""
    import numpy as np

    from ..solver import scheduling_class as sc  # lazy: avoid import cycle

    n = len(pods)
    use_prio = sc.PRIORITY_ENABLED
    use_gang = sc.GANG_ENABLED
    if not use_prio and not use_gang:
        return None
    prios = np.fromiter((p.priority for p in pods), np.int64, n)
    gids = [(p.gang() or ("", 0, 0))[0] if use_gang else "" for p in pods]
    if (not use_prio or (prios == prios[0]).all()) and not any(gids):
        return None
    neg_prio = -prios if use_prio else np.zeros(n, np.int64)
    _, gang_rank = np.unique(np.array(gids, dtype=object), return_inverse=True)
    return neg_prio, gang_rank.astype(np.int64)


def ffd_sort_with_sigs(pods: Sequence[Pod], presorted: bool = False):
    """ffd_sort plus the interned signature id and uid per sorted pod — the
    encoder consumes these directly so the batch pays one key-gathering pass.

    Returns (sorted_pods, sigs_sorted[int64], uids_sorted[str], interned) —
    see encode.sig_nums for the `interned` contract. `presorted` trusts the
    caller's order (the relaxation loop re-encodes materialized pods in the
    ORIGINAL pods' canonical order — their mutated signatures would regroup
    differently within equal-size blocks and diverge from the oracle)."""
    import numpy as np

    from ..solver.encode import sig_nums  # lazy: avoid import cycle

    n = len(pods)
    if presorted or n <= 1:
        sigs, interned = sig_nums(pods)
        uids = np.array([p.meta.uid for p in pods], dtype=object)
        return list(pods), sigs, uids, interned
    keys = [ffd_key(p) for p in pods]
    neg_cpu = np.fromiter((k[0] for k in keys), np.int64, n)
    neg_mem = np.fromiter((k[1] for k in keys), np.int64, n)
    uids = np.array([k[2] for k in keys], dtype=object)
    sigs, interned = sig_nums(pods)
    cls = _class_keys(pods)
    if cls is None:
        # primary sort: the full ffd_key (-cpu, -mem, uid)
        order0 = np.lexsort((uids, neg_mem, neg_cpu))
        cpu_s, mem_s, sig_s = neg_cpu[order0], neg_mem[order0], sigs[order0]
        # equal-(cpu,mem) block ids over the sorted sequence
        blk = np.zeros(n, np.int64)
        blk[1:] = np.cumsum((np.diff(cpu_s) != 0) | (np.diff(mem_s) != 0))
    else:
        # class-aware order: (priority desc, gang_id, existing FFD key) —
        # same lexsort, two more significant keys; signature regrouping must
        # not cross a priority or gang boundary, so those keys join the
        # equal-block condition too
        neg_prio, gang_rank = cls
        order0 = np.lexsort((uids, neg_mem, neg_cpu, gang_rank, neg_prio))
        cpu_s, mem_s, sig_s = neg_cpu[order0], neg_mem[order0], sigs[order0]
        prio_s, gang_s = neg_prio[order0], gang_rank[order0]
        blk = np.zeros(n, np.int64)
        blk[1:] = np.cumsum(
            (np.diff(cpu_s) != 0) | (np.diff(mem_s) != 0)
            | (np.diff(prio_s) != 0) | (np.diff(gang_s) != 0)
        )
    # regroup within each block by signature first-appearance: stable argsort
    # on the first sorted-position of each (block, signature) pair — constant
    # within a pair, and always inside the pair's block, so blocks never mix
    pair = blk * (np.int64(sig_s.max()) + 1) + sig_s
    _, first_idx, inv = np.unique(pair, return_index=True, return_inverse=True)
    final = order0[np.argsort(first_idx[inv], kind="stable")]
    # map over a plain-int list: cheaper than indexing with numpy ints
    sorted_pods = list(map(pods.__getitem__, final.tolist()))
    return sorted_pods, sigs[final], uids[final], interned


def node_hostname(n: "ExistingNode") -> str:
    return n.labels.get(wk.HOSTNAME_LABEL, n.id)



def _has_offering(it: InstanceType, reqs: Requirements) -> bool:
    """Any available offering admitted by `reqs`. Exact unrolling of
    `reqs.compatible(o.requirements())`: an offering constrains exactly
    {zone IN [z], ct IN [c]}, compatible() walks reqs' keys and checks
    intersects against those two, and intersects(r, IN[v]) == r.has(v)
    (single-value intersection keeps r's own bounds). The unrolled form
    skips ~5 Requirements/Requirement constructions per offering, which
    otherwise dominate a topology-heavy solve."""
    zr = reqs.get(wk.ZONE_LABEL)
    cr = reqs.get(wk.CAPACITY_TYPE_LABEL)
    for o in it.offerings:
        if (
            o.available
            and (zr is None or zr.has(o.zone))
            and (cr is None or cr.has(o.capacity_type))
        ):
            return True
    return False


def distinct_values_at_least(
    key: str, eff: "Requirement", floor: int, survivors: Sequence[InstanceType]
) -> bool:
    """True iff the surviving instance types expose >= `floor` distinct
    values for `key` admitted by the effective requirement `eff` — the ONE
    counting rule behind minValues, shared by the oracle's per-step check
    and the tensor backends' final-state post-check."""
    vals: set = set()
    for it in survivors:
        ir = it.requirements.get(key)
        if ir is not None and not ir.complement:
            vals.update(v for v in ir.values if eff.has(v))
        if len(vals) >= floor:
            return True
    return len(vals) >= floor


def min_values_ok(reqs: Requirements, survivors: Sequence[InstanceType]) -> bool:
    """NodePool minValues flexibility floors (nodepools.md:268-330): every
    requirement carrying a floor must retain >= minValues distinct values
    among the surviving instance types. Checked at every narrowing step in
    the oracle; the tensor backends check the FINAL surviving sets instead —
    equivalent, because options only ever shrink (a final state meeting the
    floor implies every intermediate superset did too)."""
    for k, r in reqs.items():
        if not r.min_values:
            continue
        if not distinct_values_at_least(k, r, r.min_values, survivors):
            return False
    return True
