"""The solver seam and the GPU backend: the port of
karpenter_tpu/solver/backend.py for the provisioning solve.

`TorchSolver` is the counterpart of `TPUSolver()` at its defaults with no
mesh sharding: encode -> padded
kernel args -> upload through the argument arena (solver/arena.py: only
stale entries, packed into one buffer, one copy, one unpack launch; an
exact repeat uploads nothing) -> the checkpointed FFD scan, with the zoned
event engine when the solve has zone/capacity-type domain sigs
(solver/cuda/ffd.py ffd_solve_ckpt) -> on-device delta compaction -> ONE
fetch -> decode. A solve whose run list shares a prefix with the bucket's
previous solve replays only the suffix from a ring checkpoint or the
previous final state (`_plan_resume`, ffd_resume) and stitches the prefix
rows back in on the host. `arena=False` uploads per array and
`resume=False` runs the plain scan, as in the JAX backend.

`sparse="auto"` (the default) evaluates the hostname and zone-sig axes
through run-major index tables (encode.sparse_run_tables, the arena's
"sparse" residency class) whenever encode.use_sparse_constraints passes:
every dispatch, the ladder's and a resume's included, then takes the
scan's sparse twin (ffd_solve_ckpt_sparse, ffd_resume_sparse, ...). "on"
takes it for any fleet with Q + V > 0, "off" never; decisions are the
same. `device_decode=False`, and any shape past the uint16 delta coding,
fetch the dense output pack (cuda/ffd.py pack_outputs) instead of the
delta compaction, as the JAX backend's `_pack_outputs`.

Respect-mode preferences (ScheduleAnyway spreads, weighted pod
(anti-)affinity, preferred node affinity; solver/relax.py) solve through
the device-resident relax ladder, one dispatch of the ladder scan
(`_ladder_dispatch`), or the host relax loop, one plain-scan dispatch per
dropped preference (`_relax_solve`), as in the JAX backend.

With the explain plane on (obs/explain.py configure(enabled=True)), a cold
dispatch also runs the explain side kernel (cuda/ffd.py explain_pack, K12)
over its device-resident take table and fetches the rejection table in one
message through the ledger (`_device_explain`); every solve path captures
its record. A resumed solve (its take rows are stitched on the host), a
relax frame (ladder or host loop: the table derives against the original
input) and a node axis past uint16 carry no device table: the host deriver
builds it (counted in stats["explain_host_derived"]). Unlike the reference,
which logs a failed explain dispatch and carries on, a kernel that fails to
build or launch here raises out of the solve: no fallback hides it.

`solve_cohort_async` serves many tenants' solves in one fused dispatch
(the serving pipeline's submit_cohort, solver/pipeline.py): members with
an equal fuse key stack into one lane-batched scan (parallel/sharded.py
batched_solve, K15; pad_batch, K16), each lane fetched and decoded on its
own. `stream_run_events = True` syncs the resident run tables through an
edit-triplet scatter (arena.apply_run_events, K14) before each solve's
adopt.

Inputs outside the port raise `UnsupportedInput`; there is no CPU
fallback solver. A later slice lifts one decline at a time.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import wellknown as wk
from ..api.objects import _POD_CACHE_KEYS
from ..obs import explain as obsexplain
from ..provisioning.scheduler import ClaimResult, SolverInput, SolverResult
from ..scheduling.requirements import IN, Requirement, Requirements
from ..utils.resources import Resources
from .arena import ArgumentArena, TransferLedger
from .cuda.ffd import ARG_INDEX
from .encode import (
    EncodedInput,
    UnpackableInput,
    _pod_signature,
    encode,
    explain_tables,
    quantize_input,
    sparse_run_tables,
    use_sparse_constraints,
)


class Solver(abc.ABC):
    @abc.abstractmethod
    def solve(self, inp: SolverInput) -> SolverResult:
        ...


def concrete_backend(solver):
    """The concrete executor at the bottom of a wrapper chain (class-aware
    and other layers delegate via `.inner` or `.solver`). Wrappers'
    `__getattr__` passthrough makes hasattr unusable here — only attributes
    in the instance __dict__ count as real links."""
    seen = set()
    while id(solver) not in seen:
        seen.add(id(solver))
        d = getattr(solver, "__dict__", {})
        nxt = d.get("inner") or d.get("solver")
        if nxt is None or isinstance(nxt, (str, bytes)):
            break
        solver = nxt
    return solver


class UnsupportedInput(ValueError):
    """The input needs a part of the solver this port does not have yet
    (fallback groups, custom-key topology, minValues replay, claim
    overflow, shapes past the scan kernel's shared rows, ...). Raised
    instead of solving on the CPU."""


def canonicalize_placements(inp: SolverInput, res: SolverResult) -> SolverResult:
    """Canonical uid→target assignment within each run of identical pods.

    Pods of one run are fungible (same signature ⇒ same scheduling
    behavior); the sequential oracle may visit targets in interleaved order
    (zone budgets rotate domains), while the tensor path assigns run pods to
    targets in (existing-node input order, then claim creation order) —
    SPEC.md "Determinism". This post-pass re-sorts the oracle's per-run
    assignments into that canonical order; per-target COUNTS, claim
    contents-as-sets, and error counts are untouched. A no-op for
    monotone-fill runs (anything without zone budgets)."""
    from dataclasses import replace as _replace

    from ..provisioning.scheduler import ffd_sort

    pods = ffd_sort([p for p in inp.pods if not p.scheduling_gated and not p.bound])
    runs: List[list] = []
    last_sig = object()
    for p in pods:
        s = _pod_signature(p)
        if runs and s == last_sig:
            runs[-1].append(p)
        else:
            runs.append([p])
            last_sig = s

    node_order = {n.id: i for i, n in enumerate(inp.nodes)}

    def tkey(t):
        if t[0] == "node":
            return (0, node_order.get(t[1], 0))
        return (1, t[1])

    placements: Dict[str, Tuple[str, object]] = {}
    errors: Dict[str, str] = {}
    claim_pods: Dict[int, List[str]] = {i: [] for i in range(len(res.claims))}
    for rp in runs:
        counts: Dict[Tuple[str, object], int] = {}
        err_msg = None
        n_err = 0
        for p in rp:
            t = res.placements.get(p.meta.uid)
            if t is None:
                n_err += 1
                err_msg = err_msg or res.errors.get(p.meta.uid, "unschedulable")
            else:
                counts[t] = counts.get(t, 0) + 1
        i = 0
        for t, c in sorted(counts.items(), key=lambda kv: tkey(kv[0])):
            for _ in range(c):
                uid = rp[i].meta.uid
                placements[uid] = t
                if t[0] == "claim":
                    claim_pods[t[1]].append(uid)
                i += 1
        for j in range(i, len(rp)):
            # keep each pod's own diagnostic when the source recorded one;
            # the run-level message only backfills pods whose uid moved
            # within the run during canonicalization
            uid = rp[j].meta.uid
            errors[uid] = res.errors.get(uid) or err_msg or "unschedulable"

    claims = [
        _replace(c, pod_uids=claim_pods[i]) for i, c in enumerate(res.claims)
    ]
    return SolverResult(placements=placements, claims=claims, errors=errors)


def pack_bits32(rows: np.ndarray) -> np.ndarray:
    """Pack a trailing bool axis (≤32 bits) into one uint32 per row."""
    nb = rows.shape[-1]
    if nb > 32:
        raise ValueError(f"cannot pack {nb} bits into uint32")
    pw = (np.uint64(1) << np.arange(nb, dtype=np.uint64)).astype(np.uint64)
    return (rows.astype(np.uint64) * pw).sum(axis=-1).astype(np.uint32)


def pack_words(rows: np.ndarray, width: int) -> np.ndarray:
    """Pack a trailing bool axis into ceil(width/32) uint32 words per row."""
    W = (width + 31) // 32
    out = np.zeros(rows.shape[:-1] + (W,), dtype=np.uint32)
    for w in range(W):
        chunk = rows[..., w * 32 : min((w + 1) * 32, rows.shape[-1])]
        if chunk.shape[-1]:
            out[..., w] = pack_bits32(chunk)
    return out


def unpack_zc_bits(bits: np.ndarray, Z: int, C: int) -> Tuple[np.ndarray, np.ndarray]:
    """Recover per-row zone/ct masks from packed joint (z*C+c) bits. Joint
    sets are always PRODUCTS (zones × cts) — intersections of products stay
    products — so the marginals reconstruct the state exactly."""
    joint = ((bits[:, None] >> np.arange(Z * C, dtype=np.uint32)[None, :]) & 1).astype(bool)
    joint = joint.reshape(-1, Z, C)
    return joint.any(axis=2), joint.any(axis=1)


# Padded HOST-side core kernel args cached across solves, keyed on the
# encode's core revision (see the JAX backend).
_CORE_HOST_CACHE: dict = {}
_CORE_HOST_CACHE_MAX = 4

STATIC_CORE_NAMES = frozenset({
    "group_req", "group_compat_t", "group_zc_bits", "group_pool",
    "group_pair_nok", "group_device", "type_alloc", "type_charge",
    "offer_zc_bits", "pool_type", "pool_zc_bits", "pool_daemon",
    "q_member", "q_owner", "q_kind", "q_cap", "v_member", "v_owner",
    "v_kind", "v_cap", "v_primary", "v_aff", "zone_col_mask", "col_axis",
    "group_daxis",
})
PER_SOLVE_NAMES = frozenset({
    "run_group", "run_count", "pool_limit", "pool_usage0", "node_free",
    "node_compat", "node_q_member", "node_q_owner", "v_count0", "node_zone",
    "node_dom2",
})


def host_kernel_args(enc: EncodedInput, bucket) -> Tuple[tuple, dict, tuple]:
    """Padded HOST (numpy) positional arrays for cuda.ffd.ffd_solve (order =
    ffd.ARG_SPEC), their dims, and per-entry provenance tokens. Shapes
    bucket to bounded sizes; zone × capacity-type admission and offering
    availability pack into uint32 bit masks; raises UnpackableInput when
    Z*C > 32."""
    INT32_MAX_NP = np.int32(2**31 - 1)
    S, G, T, E, P = len(enc.run_group), enc.G, enc.T, enc.E, enc.P
    R, Z, C = enc.group_req.shape[1], len(enc.zones), len(enc.capacity_types)
    if Z * C > 32:
        raise UnpackableInput(f"Z*C = {Z * C} exceeds the 32-bit joint-offering packing")
    Sp, Gp, Tp, Ep, Pp = (
        bucket(S, 16, 16),
        bucket(G, 16, 16),
        bucket(T, 128, 128),
        bucket(E, 32, 8),
        bucket(P, 4, 4),
    )
    Qp = bucket(enc.Q, 8, 8)
    Vp = bucket(enc.V, 4, 4)
    W = (Gp + 31) // 32

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, dtype=a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    D = len(enc.v_domains) if enc.v_domains is not None else Z
    core_rev = getattr(enc, "core_rev", -1)
    skey = (
        (core_rev, R, Z, C, Gp, Tp, Pp, Qp, Vp, D, enc.v_axis)
        if core_rev >= 0
        else None
    )
    core_args = _CORE_HOST_CACHE.get(skey) if skey is not None else None
    if core_args is None:
        zone_col = np.zeros(D, dtype=np.uint32)
        col_axis = np.zeros(D, dtype=np.int32)
        if enc.v_axis == "ct":
            lex = enc.v_domain_perm
            for d, c in enumerate(lex):
                for z in range(Z):
                    zone_col[d] |= np.uint32(1) << np.uint32(z * C + c)
        elif enc.v_axis == "mixed":
            for z in range(Z):
                for c in range(C):
                    zone_col[z] |= np.uint32(1) << np.uint32(z * C + c)
            ct_lex_idx = sorted(range(C), key=lambda i: enc.capacity_types[i])
            for d, c in enumerate(ct_lex_idx):
                col_axis[Z + d] = 1
                for z in range(Z):
                    zone_col[Z + d] |= np.uint32(1) << np.uint32(z * C + c)
        else:
            for z in range(Z):
                for c in range(C):
                    zone_col[z] |= np.uint32(1) << np.uint32(z * C + c)
        type_charge = np.where(
            enc.charge_axes[None, :], enc.type_capacity, 0
        ).astype(np.int32)
        group_zc = pack_bits32(
            (enc.group_zone[:, :, None] & enc.group_ct[:, None, :]).reshape(G, Z * C)
        )
        pool_zc = pack_bits32(
            (enc.pool_zone[:, :, None] & enc.pool_ct[:, None, :]).reshape(P, Z * C)
        )
        offer_zc = pack_bits32(enc.offer_avail.reshape(T, Z * C))
        # pairwise-INcompatibility words; padded groups are compatible with all
        pair_nok = pack_words(~pad(enc.group_pair, (Gp, Gp), fill=True), Gp)
        core_args = {
            "group_req": pad(enc.group_req, (Gp, R)),
            "group_compat_t": pad(enc.group_compat_t, (Gp, Tp)),
            "group_zc_bits": pad(group_zc, (Gp,)),
            "group_pool": pad(enc.group_pool, (Gp, Pp)),
            "group_pair_nok": pair_nok,
            "group_device": pad(~enc.group_fallback, (Gp,)),
            "type_alloc": pad(enc.type_alloc, (Tp, R)),
            "type_charge": pad(type_charge, (Tp, R)),
            "offer_zc_bits": pad(offer_zc, (Tp,)),
            "pool_type": pad(enc.pool_type, (Pp, Tp)),
            "pool_zc_bits": pad(pool_zc, (Pp,)),
            "pool_daemon": pad(enc.pool_daemon, (Pp, R)),
            "q_member": pad(enc.q_member, (Gp, Qp)),
            "q_owner": pad(enc.q_owner, (Gp, Qp)),
            "q_kind": pad(enc.q_kind, (Qp,)),
            "q_cap": pad(enc.q_cap, (Qp,), fill=1),
            "v_member": pad(enc.v_member, (Gp, Vp)),
            "v_owner": pad(enc.v_owner, (Gp, Vp)),
            "v_kind": pad(enc.v_kind, (Vp,)),
            "v_cap": pad(enc.v_cap, (Vp,), fill=1),
            "v_primary": pad(enc.v_primary, (Gp,), fill=np.int32(-1)),
            "v_aff": pad(enc.v_aff, (Gp,), fill=np.int32(-1)),
            "zone_col_mask": zone_col,
            "col_axis": col_axis,
            "group_daxis": (
                pad(enc.group_daxis, (Gp,))
                if enc.group_daxis is not None
                else np.zeros(Gp, np.int32)
            ),
        }
        if skey is not None:
            if len(_CORE_HOST_CACHE) >= _CORE_HOST_CACHE_MAX:
                _CORE_HOST_CACHE.pop(next(iter(_CORE_HOST_CACHE)))
            _CORE_HOST_CACHE[skey] = core_args
    per_solve = {
        "run_group": pad(enc.run_group, (Sp,)),
        "run_count": pad(enc.run_count, (Sp,)),
        "pool_limit": pad(enc.pool_limit, (Pp, R), fill=INT32_MAX_NP),
        "pool_usage0": pad(enc.pool_usage, (Pp, R)),
        "node_free": pad(enc.node_free, (Ep, R)),
        "node_compat": pad(enc.node_compat, (Gp, Ep)),
        "node_q_member": pad(enc.node_q_member, (Ep, Qp)),
        "node_q_owner": pad(enc.node_q_owner, (Ep, Qp)),
        "v_count0": pad(enc.v_count0, (Vp, D)),
        "node_zone": pad(
            enc.v_node_domain if enc.v_node_domain is not None else enc.node_zone,
            (Ep,),
            fill=np.int32(-1),
        ),
        "node_dom2": (
            pad(enc.node_dom2, (Ep,), fill=np.int32(-1))
            if enc.node_dom2 is not None
            else np.full(Ep, -1, np.int32)
        ),
    }
    from .cuda.ffd import ARG_SPEC

    assert STATIC_CORE_NAMES | PER_SOLVE_NAMES == set(ARG_SPEC) and not (
        STATIC_CORE_NAMES & PER_SOLVE_NAMES
    ), "static/per-solve partition out of sync with ffd.ARG_SPEC"
    args = tuple(
        core_args[n] if n in STATIC_CORE_NAMES else per_solve[n] for n in ARG_SPEC
    )
    prov = tuple(
        (skey, n) if (skey is not None and n in STATIC_CORE_NAMES) else None
        for n in ARG_SPEC
    )
    dims = dict(
        S=S, G=G, T=T, E=E, P=P, R=R, Z=Z, C=C,
        Sp=Sp, Gp=Gp, Tp=Tp, Ep=Ep, Pp=Pp, Qp=Qp, Vp=Vp, W=W,
    )
    return args, dims, prov


def check_kernel_limits(dims: dict, host_args: tuple, zone: bool, device) -> None:
    """Raise UnsupportedInput when the padded shapes exceed the scan
    kernel's shared rows (Q, R; with the zoned branch also the domain
    columns, the pools and V, whose cap is the card's: cuda/ffd.py
    zone_v_cap, none on the CPU)."""
    from .cuda import ffd as cffd

    if dims["Qp"] > cffd.MAX_Q or dims["R"] > cffd.MAX_R:
        raise UnsupportedInput(
            f"Qp={dims['Qp']} or R={dims['R']} exceeds the scan kernel's shared rows"
        )
    if not zone:
        return
    D = len(host_args[ARG_INDEX["zone_col_mask"]])
    if D > cffd.MAX_Z or dims["Pp"] > cffd.MAX_P:
        raise UnsupportedInput(
            f"{D} domain columns or Pp={dims['Pp']} exceed the zoned scan kernel's shared rows"
        )
    cap = cffd.zone_v_cap(device)
    if cap is not None and dims["Vp"] > cap:
        raise UnsupportedInput(
            f"Vp={dims['Vp']} exceeds the zoned scan kernel's {cap} V rows on this card"
        )


def min_values_post_check(qinp: SolverInput, result: SolverResult) -> bool:
    """minValues floors: each claim's FINAL surviving type set must expose
    the floor's distinct values (equivalent to the oracle's per-add checks
    because options only shrink)."""
    floors = {}
    types_by_pool = {}
    for p in qinp.nodepools:
        fl = [(k, r) for k, r in p.requirements.items() if r.min_values]
        if fl:
            floors[p.name] = fl
            types_by_pool[p.name] = {it.name: it for it in p.instance_types}
    if not floors:
        return True
    from ..provisioning.scheduler import distinct_values_at_least

    for claim in result.claims:
        fl = floors.get(claim.nodepool)
        if not fl:
            continue
        types = types_by_pool[claim.nodepool]
        survivors = [types[n] for n in claim.instance_type_names if n in types]
        for k, r in fl:
            eff = r
            cr = claim.requirements.get(k)
            if cr is not None:
                eff = r.intersect(cr)
            if not distinct_values_at_least(k, eff, r.min_values, survivors):
                return False
    return True


def initial_claim_bucket(total_pods: int, max_claims: int) -> int:
    """First claim-slot bucket M: the smallest power-of-two ≥
    min(total_pods+1, 512), capped at max_claims. The solver doubles on
    saturation."""
    M = 64
    while M < min(total_pods + 1, 512):
        M *= 2
    return min(M, max(max_claims, 64))


DELTA_CAP_QUANTUM = 256  # entry-capacity bucket
DELTA_UNIQ_QUANTUM = 16  # unique claim-meta row capacity bucket


def delta_capacity(total_pods: int, Sp: int, Ep: int, Mb: int) -> int:
    """Entry capacity of the claim-delta buffer: every nonzero take entry
    accounts for ≥ 1 placed pod; a solve that exceeds the capacity trips
    the overflow flag and re-fetches full width."""
    need = min(total_pods, Sp + 2 * Ep + 4 * Mb, Sp * (Ep + Mb))
    q = DELTA_CAP_QUANTUM
    return max(q, ((need + q - 1) // q) * q)


def delta_uniq_capacity(Sp: int, Mb: int) -> int:
    """Unique claim-meta row capacity (distinct rows track deployment
    waves, not claims); excess trips the overflow re-fetch."""
    q = DELTA_UNIQ_QUANTUM
    need = min(Mb, Sp + 48)
    return max(q, ((need + q - 1) // q) * q)


def _pack_outputs_delta(out, cap: int, cap_u: int) -> torch.Tensor:
    """ONE int32 device buffer: header [overflow, n, n_u], per-run entry
    counts, (code, count) entries (compact_takes), leftovers, the deduped
    claim identity rows and their ids (compact_claim_meta), and `used`.
    c_cum never crosses; the host rebuilds it from the entries."""
    from .cuda.ffd import compact_claim_meta, compact_takes

    st = out.state
    overflow_t, n, cnt16, pairs = compact_takes(out.take_e, out.take_c, cap)
    overflow_u, n_u, uniq, mid16, _meta = compact_claim_meta(
        st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, cap_u
    )
    parts = [
        (overflow_t | overflow_u).reshape(1),
        n.reshape(1),
        n_u.reshape(1),
        cnt16.reshape(-1),
        pairs.reshape(-1),
        out.leftover.reshape(-1),
        uniq.reshape(-1),
        mid16.reshape(-1),
        st.used.reshape(1),
    ]
    return torch.cat(parts)


def _pack_outputs_wide(out) -> torch.Tensor:
    """Full-width int32 packing — the overflow fallback of the delta pack.
    The type-mask words come from the claim-meta kernel's word pack."""
    from .cuda.ffd import compact_claim_meta

    st = out.state
    M, Tp = st.c_mask.shape
    Wm = (Tp + 31) // 32
    meta = compact_claim_meta(st.c_mask, st.c_zc_bits, st.c_gbits, st.c_pool, 16)[4]
    parts = [
        out.take_e.reshape(-1),
        out.take_c.reshape(-1),
        out.leftover.reshape(-1),
        meta[:, :Wm].reshape(-1),
        st.c_zc_bits.reshape(-1),
        st.c_gbits.reshape(-1),
        st.c_pool.reshape(-1),
        st.c_cum.reshape(-1),
        st.used.reshape(1),
    ]
    return torch.cat(parts)


def _pack_outputs(out) -> torch.Tensor:
    """The dense output pack (JAX backend.py:511): every host-decoded
    output in ONE int32 buffer, the take grids as uint16 pairs behind an
    overflow flag (cuda/ffd.py pack_outputs)."""
    from .cuda.ffd import pack_outputs

    return pack_outputs(out.take_e, out.take_c, out.leftover, out.state)


def _unpack_flat(flat: np.ndarray, shapes: dict) -> dict:
    """Host-side inverse of the wide pack."""
    res = {}
    off = 0
    for name, (shape, dtype) in shapes.items():
        n = int(np.prod(shape)) if shape else 1
        a = flat[off : off + n]
        off += n
        if dtype == "u32":
            a = a.view(np.uint32)
        res[name] = a.reshape(shape) if shape else a[0]
    return res


class _CohortOverflow(Exception):
    """Internal: a fused cohort lane saturated its claim bucket. The member
    replays through its full solo path (which owns the M-doubling ladder);
    co-members keep their fused results. Never escapes the backend."""


class AsyncSolve:
    """Handle for an in-flight solve: the kernels are enqueued; result()
    fetches, decodes and returns the SolverResult (once)."""

    def __init__(self, fn):
        self._fn = fn
        self._result: Optional[SolverResult] = None
        self._done = False

    def result(self) -> SolverResult:
        if not self._done:
            self._result = self._fn()
            self._done = True
        return self._result


def materialize_pods(order, items_map, level) -> list:
    """relax.materialize_pod over the ordered pods, pod p at rung level(p),
    pods without preferences as they are. Equal, pod by pod, to calling
    materialize_pod on each (tests/test_torch_relax.py), but a pod whose
    signature, preference fields, item list and level equal those of the
    pod that opened its stretch shares that pod's materialized fields and
    signature instead of rebuilding them: the per-pod dataclass rebuild and
    signature are most of a 50k-pod ladder's host time."""
    import copy

    from . import relax as rx

    out = []
    head = None  # (original pod, items, level, its materialization)
    for p in order:
        items = items_map.get(p.meta.uid)
        if items is None:
            out.append(p)
            head = None
            continue
        lvl = level(p)
        if (
            head is not None and head[2] == lvl and head[1] == items
            and _pod_signature(head[0]) == _pod_signature(p)
            and head[0].topology_spread == p.topology_spread
            and head[0].affinity_terms == p.affinity_terms
            and head[0].node_affinity == p.node_affinity
            and head[0].preferred_node_affinity == p.preferred_node_affinity
        ):
            m = head[3]
            q = copy.copy(p)
            d = q.__dict__
            for k in _POD_CACHE_KEYS:
                d.pop(k, None)
            d.update(topology_spread=m.topology_spread, affinity_terms=m.affinity_terms,
                     node_affinity=m.node_affinity,
                     preferred_node_affinity=m.preferred_node_affinity)
            # equal fields, equal signature: seed encode._pod_signature's cache
            d["_solver_sig"] = _pod_signature(m)
        else:
            q = rx.materialize_pod(p, items, lvl)
            head = (p, items, lvl, q)
        out.append(q)
    return out


def ladder_pods(items_map, order):
    """The relax ladder's pods: the ordered pods materialized at level 0
    (the base runs, as the host loop's first iteration) and, for every run,
    one GHOST pod per rung l >= 1 (the run's representative with its l
    lowest-weight preferences dropped), appended after the originals.
    Returns (pods0, runs [[start, count]], ladders, ghosts, ghost_of
    [(run, level)]), or None when a run mixes different ladders (its pods'
    (weight, kind, idx) item lists differ) or no pod has a rung."""
    import dataclasses

    from . import relax as rx

    pods0 = materialize_pods(order, items_map, lambda p: 0)
    if not pods0:
        return None
    sigs = [_pod_signature(p) for p in pods0]
    runs: List[List[int]] = []
    for i, sg in enumerate(sigs):
        if runs and sg == sigs[i - 1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    ladders = []
    for start, cnt in runs:
        keys = {
            tuple((w, k, ix) for (w, k, _t, ix) in items_map.get(order[j].meta.uid, ()))
            for j in range(start, start + cnt)
        }
        if len(keys) != 1:
            return None  # mixed ladder within one run: host loop
        ladders.append(next(iter(keys)))
    ghosts, ghost_of = [], []
    for ri, (start, _cnt) in enumerate(runs):
        items = items_map.get(order[start].meta.uid, ())
        rep = order[start]
        for lvl in range(1, len(items) + 1):
            gp = rx.materialize_pod(rep, items, lvl)
            gp = dataclasses.replace(
                gp,
                meta=dataclasses.replace(
                    gp.meta, name=f"~rung-{lvl}-{rep.meta.name}", uid=f"~rung:{rep.meta.uid}:{lvl}"
                ),
            )
            ghosts.append(gp)
            ghost_of.append((ri, lvl))
    if not ghosts:
        return None
    return pods0, runs, ladders, ghosts, ghost_of


def ladder_table(enc: EncodedInput, n_orig: int, runs, ladders, ghosts, ghost_of, bucket):
    """The rung table of an encode of ladder_pods' pods: encode interns the
    rungs' group tables (a rung merges with any same-spec group, as the
    host loop's re-encode would), then the run axis is truncated to the
    original runs, so a ghost never pours. run_ladder[s, l-1] holds rung
    l's group, -1 past the run's ladder; its width is bucket(Lmax, 2, 2).
    Returns (truncated encode, run_ladder [S, Lp] int32, Lmax), or None
    when a ghost merged into the last original run, encode split the
    originals differently or did not keep the presorted order."""
    import dataclasses

    rc = np.asarray(enc.run_count)
    rg = np.asarray(enc.run_group)
    cum = np.cumsum(rc)
    bidx = int(np.searchsorted(cum, n_orig))
    if bidx >= len(rc) or int(cum[bidx]) != n_orig:
        return None  # a ghost merged into the last original run
    S_orig = bidx + 1
    if S_orig != len(runs) or not np.array_equal(
        rc[:S_orig], np.asarray([c for _, c in runs], dtype=rc.dtype)
    ):
        return None  # encode split the originals differently
    if str(enc.sorted_uids[n_orig]) != ghosts[0].meta.uid:
        return None  # presorted order not preserved
    pod_run = np.repeat(np.arange(len(rc)), rc)
    Lmax = max(len(l) for l in ladders)
    ladder_rows = np.full((S_orig, bucket(Lmax, 2, 2)), -1, np.int32)
    for j, (ri, lvl) in enumerate(ghost_of):
        ladder_rows[ri, lvl - 1] = rg[pod_run[n_orig + j]]
    # the group axis (and group_pods, for decode's requirement unions)
    # keeps the rung groups
    enc2 = dataclasses.replace(
        enc,
        run_group=np.ascontiguousarray(rg[:S_orig]),
        run_count=np.ascontiguousarray(rc[:S_orig]),
        sorted_uids=enc.sorted_uids[:n_orig],
    )
    return enc2, ladder_rows, int(Lmax)


def pad_ladder(ladder_rows: np.ndarray, Sp: int) -> np.ndarray:
    """The rung table padded to the kernel's run axis (-1 rows)."""
    out = np.full((Sp, ladder_rows.shape[1]), -1, np.int32)
    out[: ladder_rows.shape[0]] = ladder_rows
    return out


class TorchSolver(Solver):
    """Tensorized FFD on the GPU (solver/cuda/ffd.py). `device=None` means
    "cuda" and raises when no GPU is present; `device="cpu"` runs the plain
    PyTorch versions of the kernels. `relax_ladder=False` serves
    preferences through the host relax loop instead of the ladder scan.

    `arena` keeps the kernel args resident per shape bucket and uploads
    only stale entries as one packed buffer (False: one upload per array);
    `arena_budget_mb` > 0 bounds its residency. `resume` (forced off
    without the arena) harvests a checkpoint ring every `ckpt_every` scan
    steps into `ckpt_slots` slots on every cold dispatch and replays only
    the run suffix of a later solve that shares a prefix with it. `sparse`
    ("auto" | "on" | "off") picks the sparse scan twins by the density gate,
    for any constrained fleet, or never; `device_decode=False` fetches the
    dense output pack. The defaults are TPUSolver's."""

    def __init__(self, max_claims: int = 1024, device=None, relax_ladder: bool = True,
                 arena: bool = True, resume: bool = True, ckpt_every: int = 16,
                 ckpt_slots: int = 4, arena_budget_mb: int = 0, sparse: str = "auto",
                 device_decode: bool = True):
        if sparse not in ("auto", "on", "off"):
            raise ValueError(f"sparse must be auto/on/off, got {sparse!r}")
        self.sparse = sparse
        # the claim-delta fetch (compact_takes + claim_meta); False = the
        # dense output pack
        self.device_decode = bool(device_decode)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver: CUDA is not available (pass device='cpu' for the "
                "plain PyTorch path)"
            )
        self.device = dev
        self.max_claims = max_claims
        self.relax_ladder = bool(relax_ladder)
        self.stats: Dict[str, int] = {
            "device_solves": 0, "wide_refetches": 0, "claim_doublings": 0,
            "ladder_solves": 0, "relax_dispatches": 0, "ladder_rungs_used": 0,
            "resume_solves": 0, "resume_runs_skipped": 0, "sparse_dispatches": 0,
            # explain plane: K12 dispatches, node axes past uint16, and
            # captures the host deriver builds
            "explain_dispatches": 0, "explain_wide": 0, "explain_host_derived": 0,
            # streaming run-table staging and the fused cohort dispatch
            "event_stage_hits": 0, "event_stage_misses": 0,
            "fused_dispatches": 0, "fused_members": 0,
        }
        # streaming run-table staging: when on, each device solve first
        # tries to sync the arena's resident run tables through an
        # edit-triplet scatter (arena.apply_run_events, K14) so adopt() sees
        # them fresh and the upload shrinks to the triplets. Off by default,
        # as in the JAX backend; decisions are the same either way
        self.stream_run_events = False
        # h2d bytes each fused cohort member is billed (tenant -> bytes; a
        # member without a tenant counts as "default"): exactly the bytes
        # its solo dispatch would upload for the entries the fused adopt
        # found stale, the JAX backend's per-tenant meter (obs/slo
        # meter_bytes) on that path
        self.tenant_h2d_bytes: Dict[str, int] = {}
        # every host->device and device->host byte, per solve and in all
        self.ledger = TransferLedger()
        self.arena: Optional[ArgumentArena] = (
            ArgumentArena(self.ledger, device=dev,
                          budget_bytes=max(0, int(arena_budget_mb)) * 1024 * 1024)
            if arena else None
        )
        # the checkpoints are a residency class of the arena (they die with
        # it on invalidate()), so resume requires the arena
        self.resume = bool(resume) and arena
        self.ckpt_every = max(1, int(ckpt_every))
        self.ckpt_slots = max(1, int(ckpt_slots))
        # arena=False: device copies of provenance-tagged static arrays (see
        # host_kernel_args): a solve over an unchanged encode core uploads
        # only its per-solve arrays
        self._dev_cache: Dict[tuple, torch.Tensor] = {}

    def invalidate_arena(self) -> None:
        """Drop every resident kernel-arg tensor AND the checkpoints (derived
        state of the same solves). The next device solve pays one full
        packed upload and runs cold."""
        if self.arena is not None:
            self.arena.invalidate()

    @property
    def resume_hit_rate(self) -> float:
        """Fraction of device dispatches that resumed from a checkpoint."""
        return self.stats["resume_solves"] / max(1, self.ledger.solves)

    @staticmethod
    def _bucket(n: int, mult: int, floor: int) -> int:
        return max(floor, ((n + mult - 1) // mult) * mult)

    def solve(self, inp: SolverInput) -> SolverResult:
        return self.solve_async(inp).result()

    def solve_async(self, inp: SolverInput) -> AsyncSolve:
        """Encode + dispatch now; fetch + decode when result() is called."""
        qinp = quantize_input(inp)
        from . import relax as rx

        relax_plan = rx.plan(qinp)
        if relax_plan is not None:
            # Respect-mode preferences: the ladder scan in one dispatch, or
            # the host loop's redispatch per dropped preference. Sort the
            # FILTERED list (gated/bound pods dropped first), as the oracle
            # and the JAX backend do.
            from ..provisioning.scheduler import ffd_sort

            order = ffd_sort(
                [p for p in qinp.pods if not p.scheduling_gated and p.node_name is None]
            )
            if self.relax_ladder:
                lad = self._ladder_dispatch(qinp, relax_plan, order)
                if lad is not None:
                    return AsyncSolve(
                        lambda: self._ladder_finish(qinp, relax_plan, order, lad)
                    )
            dropped = {u: 0 for u in relax_plan}
            first = self._relax_dispatch(qinp, relax_plan, order, dropped)
            return AsyncSolve(
                lambda: self._relax_solve(qinp, relax_plan, order, dropped, first)
            )
        enc = encode(qinp)
        _check_encode(enc)
        if enc.G == 0:
            # no schedulable pod: the empty result every backend returns
            def empty():
                res = _empty_result()
                self._capture(qinp, res)
                return res

            return AsyncSolve(empty)
        handle = self._device_solve_async(enc)

        def finish():
            out = handle()
            if not min_values_post_check(qinp, out):
                raise UnsupportedInput("a claim narrowed below a minValues floor")
            self.stats["device_solves"] += 1
            # the table decoded from the explain wire rides the result; None
            # (a resumed solve, a node axis past uint16) host-derives
            self._capture(qinp, out, enc=enc, table=getattr(out, "_explain_table", None))
            return out

        return AsyncSolve(finish)

    def _capture(self, qinp, res, enc=None, table=None, annotations=None) -> None:
        """The solve's explain record (obs/explain.py capture), when the
        plane is on; a capture without a device table host-derives."""
        if not obsexplain.enabled():
            return
        if table is None:
            self.stats["explain_host_derived"] += 1
        obsexplain.capture(qinp, res, "torch", enc=enc, table=table, annotations=annotations)

    # -- cross-tenant fused cohort dispatch -------------------------------------

    def _cohort_prep(self, inp: SolverInput):
        """Probe one member's fuse eligibility WITHOUT dispatching. Returns
        the prepared per-member state, or None when the member must ride its
        exact solo path (relax plan, fallback or custom-key topology/affinity
        encode, no schedulable pod, unpackable args; in the port also shapes
        past the scan kernel's shared rows, whose solo path raises
        UnsupportedInput): the caller re-submits it through solve_async."""
        qinp = quantize_input(inp)
        from . import relax as rx

        if rx.plan(qinp) is not None:
            return None
        enc = encode(qinp)
        if enc.group_fallback.any() or enc.has_topology or enc.has_affinity or enc.G == 0:
            return None
        try:
            host_args, dims, prov = host_kernel_args(enc, self._bucket)
        except UnpackableInput:
            return None
        try:
            check_kernel_limits(dims, host_args, enc.V > 0, self.device)
        except UnsupportedInput:
            return None
        total_pods = int(sum(len(p) for p in enc.group_pods))
        M0 = initial_claim_bucket(total_pods, self.max_claims)
        # exact fuse key: identical padded shapes/dtypes (one kernel
        # instance over equal strides), same zone-engine flag, same claim
        # bucket
        fkey = (
            tuple((a.shape, a.dtype.str) for a in host_args),
            bool(enc.V > 0),
            M0,
        )
        return {
            "inp": inp, "qinp": qinp, "enc": enc, "host_args": host_args,
            "dims": dims, "total_pods": total_pods, "M0": M0, "fkey": fkey,
        }

    def solve_cohort_async(self, inps):
        """Fused cohort entry point: dispatch MANY tenants' solves as one
        lane-batched launch (parallel/sharded.py batched_solve, K15, over
        the ARG_SPEC tensors stacked member-major), then fan the fused
        result out to per-member decode. Returns finish() -> list aligned
        with `inps`, each element a SolverResult or the Exception that
        member's path raised: one poison member never fails its
        co-members.

        Members whose exact fuse key (padded shapes + zone-engine flag +
        claim bucket) matches no co-member, or whose input needs a solo-only
        path (relax, a fallback-class encode), are re-submitted through
        solve_async and keep their solo semantics. Each fused member's
        decode, explain capture and h2d billing replicate its solo
        dispatch's."""
        n = len(inps)
        solo: dict = {}
        preps: list = [None] * n
        groups: Dict[tuple, list] = {}  # fuse key -> member indices, first-seen order
        for i, inp in enumerate(inps):
            try:
                preps[i] = self._cohort_prep(inp)
            except Exception as e:  # noqa: BLE001 — isolate per member
                solo[i] = e
                continue
            if preps[i] is not None:
                groups.setdefault(preps[i]["fkey"], []).append(i)
        for fkey, idxs in list(groups.items()):
            if len(idxs) < 2:
                del groups[fkey]
        fused_idx = {i for idxs in groups.values() for i in idxs}
        for i in range(n):
            if i in fused_idx or i in solo:
                continue
            try:
                solo[i] = self.solve_async(inps[i])
            except Exception as e:  # noqa: BLE001 — isolate per member
                solo[i] = e
        finishers = []
        for idxs in groups.values():
            try:
                finishers.append(self._cohort_dispatch(idxs, preps))
            except Exception as e:  # noqa: BLE001 — a whole-dispatch failure
                # is every member's error; attribution stays per member
                finishers.append(lambda _e=e, _ix=tuple(idxs): {i: _e for i in _ix})

        def finish():
            results: list = [None] * n
            fused_results: dict = {}
            for g in finishers:
                fused_results.update(g())
            for i in range(n):
                if i in fused_results:
                    results[i] = fused_results[i]
                    continue
                h = solo.get(i)
                if isinstance(h, BaseException):
                    results[i] = h
                    continue
                try:
                    results[i] = h.result()
                except Exception as e:  # noqa: BLE001 — per-member outcome
                    results[i] = e
            return results

        return finish

    def _cohort_dispatch(self, idxs, preps):
        """One fused launch for `idxs` (all sharing a fuse key): stack the
        36 host arrays member-major, adopt the stack under the shared
        cohort namespace (each tenant's own buckets stay authoritative for
        solo replays), pad to the batch bucket with the last member's lane
        (K16), solve every lane (K15), and pack each lane's output for one
        fetch. Returns finish() -> {index: outcome}."""
        from ..parallel.sharded import batch_bucket, batched_solve, pad_batch
        from .cuda.ffd import output_lane

        n_real = len(idxs)
        lead = preps[idxs[0]]
        zone = lead["fkey"][1]
        M0 = lead["M0"]
        # power-of-two cohort bucket (bounded shapes per fuse key); the
        # batch runs on one card
        B = batch_bucket(1 << (n_real - 1).bit_length(), 1, mult=1)
        arity = len(lead["host_args"])
        stacked = tuple(np.stack([preps[i]["host_args"][j] for i in idxs])
                        for j in range(arity))
        self.ledger.begin_solve()
        if self.arena is not None:
            args = self.arena.adopt(stacked, (None,) * arity, ns="__cohort__")
            stale = self.arena.last_stale
        else:
            args = self._device_args(stacked, (None,) * arity)
            stale = tuple(range(arity))
        # per-member h2d billing: a member pays exactly the bytes its solo
        # dispatch would have uploaded for the entries this adopt found
        # stale (its own rows of the stacked arrays)
        for i in idxs:
            h2d = sum(int(preps[i]["host_args"][j].nbytes) for j in stale)
            if h2d:
                t = preps[i]["enc"].tenant_id or "default"
                self.tenant_h2d_bytes[t] = self.tenant_h2d_bytes.get(t, 0) + h2d
        args = pad_batch(args, B)
        out = batched_solve(args, max_claims=M0, zone_engine=zone)
        self.stats["fused_dispatches"] += 1
        self.stats["fused_members"] += n_real
        flats = []
        for k, i in enumerate(idxs):
            lane = output_lane(out, k)
            flat_dev, unpack = self._pack_dispatch(lane, preps[i]["total_pods"])
            flats.append((i, lane, flat_dev, unpack))

        def finish():
            results: dict = {}
            replays: list = []
            try:
                for i, lane, flat_dev, unpack in flats:
                    try:
                        results[i] = self._cohort_lane_finish(preps[i], lane, flat_dev,
                                                              unpack, M0)
                    except _CohortOverflow:
                        replays.append(i)
                    except Exception as e:  # noqa: BLE001 — poison member:
                        results[i] = e  # only ITS lane fails
            finally:
                self.ledger.end_solve()
            for i in replays:
                # claim-slot saturation at M0: the solo path owns the
                # doubling ladder; replay the member whole (its tenant's
                # arena buckets are untouched by the fused adopt)
                try:
                    results[i] = self.solve_async(preps[i]["inp"]).result()
                except Exception as e:  # noqa: BLE001 — per-member outcome
                    results[i] = e
            return results

        return finish

    def _cohort_lane_finish(self, prep, lane, flat_dev, unpack, M0: int) -> SolverResult:
        """Fetch + decode ONE fused lane: the solo finish path minus resume
        (fused lanes never resume; solo replays still do) and minus the
        in-place claim doubling (raises _CohortOverflow so the caller
        replays the member through solve_async). A lane whose decode fails
        a minValues floor raises UnsupportedInput for that member alone."""
        enc, qinp = prep["enc"], prep["qinp"]
        f = unpack(self._fetch(flat_dev))
        used = int(f["used"])
        if used >= M0:
            raise _CohortOverflow()
        res = self._decode_fetched(enc, prep["dims"], f, M0, used)
        if not min_values_post_check(qinp, res):
            raise UnsupportedInput("a claim narrowed below a minValues floor")
        self.stats["device_solves"] += 1
        if obsexplain.enabled():
            # the same explain contract as a cold solo dispatch: K12 over
            # this lane's device-resident take table
            self._capture(qinp, res, enc=enc, table=self._device_explain(enc, lane))
        return res

    # -- host relax loop -------------------------------------------------------

    def _relax_dispatch(self, qinp, items_map, order, dropped):
        """Materialize + encode + dispatch one relax iteration (through
        _device_solve_async: it adopts, harvests and may resume like any
        solve): (minp, enc, finish), finish None when no pod is
        schedulable."""
        import dataclasses

        pods2 = materialize_pods(order, items_map, lambda p: dropped[p.meta.uid])
        minp = dataclasses.replace(qinp, pods=pods2, presorted=True)
        enc = encode(minp)
        _check_encode(enc)
        if enc.G == 0:
            return minp, enc, None
        return minp, enc, self._device_solve_async(enc)

    def _relax_solve(self, qinp: SolverInput, items_map, order, dropped,
                     first=None) -> SolverResult:
        """Drive the oracle's per-pod relaxation by whole-solve redispatch:
        each iteration materializes the current per-pod active preference
        sets (in the ORIGINAL pods' FFD order) and solves on the device; the
        FIRST failing pod with droppable preferences left drops its
        lowest-weight one. Pods before the relaxed one replay identically,
        the relaxed pod retries under the same state, so the result is the
        sequential oracle's."""
        budget = 1 + sum(len(v) for v in items_map.values())
        for it in range(budget):
            minp, enc, finish = first if (it == 0 and first is not None) else (
                self._relax_dispatch(qinp, items_map, order, dropped)
            )
            out = finish() if finish is not None else _empty_result()
            if not min_values_post_check(minp, out):
                raise UnsupportedInput("a claim narrowed below a minValues floor")
            cand = None
            for uid in enc.sorted_uids.tolist():
                if uid in out.errors and dropped.get(uid, 0) < len(items_map.get(uid, ())):
                    cand = uid
                    break
            if cand is None:
                self.stats["device_solves"] += 1
                self.stats["relax_dispatches"] = it + 1
                self.stats["ladder_rungs_used"] = max(dropped.values(), default=0)
                # per-pod relaxation SPLITS original runs, so fungible-pod
                # assignments are canonicalized over the ORIGINAL pods
                final = canonicalize_placements(qinp, out)
                # relaxed runs differ from the original encode frame: the
                # table host-derives against the ORIGINAL input; the rungs
                # each pod dropped ride as a leg annotation
                self._capture(qinp, final, annotations={
                    "relax_dispatches": it + 1,
                    "relax_dropped": {u: r for u, r in dropped.items() if r},
                })
                return final
            dropped[cand] += 1
        raise UnsupportedInput("the relax loop did not settle within its dispatch budget")

    # -- device-resident relax ladder -----------------------------------------

    def _ladder_dispatch(self, qinp, items_map, order):
        """Pre-materialize the whole relax ladder (ladder_pods, encode,
        ladder_table) and dispatch it as ONE launch of the ladder scan
        (cuda/ffd.py ffd_solve_ladder) instead of the host loop's dispatch
        per dropped preference. Returns an in-flight dispatch record, or
        None to use the host loop: where ladder_pods or ladder_table decline,
        a fallback-class encode, unpackable kernel args, or shapes past the
        scan kernel's shared rows."""
        import dataclasses

        lp = ladder_pods(items_map, order)
        if lp is None:
            return None
        pods0, runs, ladders, ghosts, ghost_of = lp
        enc = encode(dataclasses.replace(qinp, pods=pods0 + ghosts, presorted=True))
        if enc.group_fallback.any() or enc.has_topology or enc.has_affinity or enc.G == 0:
            return None
        lt = ladder_table(enc, len(pods0), runs, ladders, ghosts, ghost_of, self._bucket)
        if lt is None:
            return None
        enc2, ladder_rows, rungs = lt
        try:
            host_args, dims, prov = host_kernel_args(enc2, self._bucket)
        except UnpackableInput:
            return None
        zone = enc2.V > 0
        try:
            check_kernel_limits(dims, host_args, zone, self.device)
        except UnsupportedInput:
            return None
        self.ledger.begin_solve()
        args = self._upload(host_args, prov, enc2.tenant_id)
        dev_lad = self._ladder_arg(host_args, pad_ladder(ladder_rows, dims["Sp"]),
                                   enc2.tenant_id)
        sparse = None
        if self._sparse_gate(enc2):
            # each row the union over the run's base and rung groups
            sq, sv = sparse_run_tables(enc2, dims["Sp"], run_ladder=ladder_rows)
            sparse = self._sparse_arg(host_args, enc2, sq, sv, ns=enc2.tenant_id)
        n_orig = len(pods0)
        M0 = initial_claim_bucket(n_orig, self.max_claims)
        flat_dev, unpack, _, _ = self._dispatch(args, M0, n_orig, zone, ladder=dev_lad,
                                                sparse=sparse)
        return dict(enc=enc2, args=args, dev_lad=dev_lad, flat_dev=flat_dev, unpack=unpack,
                    dims=dims, M0=M0, n_orig=n_orig, zone=zone, rungs=rungs, sparse=sparse)

    def _ladder_arg(self, host_args, lad_host: np.ndarray, ns=None) -> torch.Tensor:
        """Upload (or reuse) the run_ladder table: with the arena it is a
        per-bucket residency class keyed by content, dropped by
        invalidate() with the args and checkpoints."""
        from .convert import array_to_torch

        key = None
        if self.arena is not None:
            key = self.arena.bucket_key(host_args, ns=ns)
            dev = self.arena.get_ladder(key, lad_host)
            if dev is not None:
                return dev
        dev = array_to_torch(lad_host, self.device)
        self.ledger.record_upload(lad_host.nbytes, 1, msgs=1)
        if key is not None:
            self.arena.put_ladder(key, lad_host, dev)
        return dev

    def _ladder_finish(self, qinp: SolverInput, items_map, order, lad) -> SolverResult:
        """Fetch + decode the ladder dispatch. A result that cannot stand
        (claims past max_claims, a minValues violation) replays on the host
        relax loop, which raises UnsupportedInput where it cannot finish:
        the ladder only ever shortcuts the host loop."""
        try:
            res = self._collect(lad["enc"], lad["dims"], lad["args"], lad["flat_dev"],
                                lad["unpack"], lad["M0"], lad["n_orig"], lad["zone"],
                                ladder=lad["dev_lad"], sparse=lad["sparse"])
        finally:
            self.ledger.end_solve()
        if res is not None and min_values_post_check(qinp, res):
            self.stats["device_solves"] += 1
            self.stats["ladder_solves"] += 1
            self.stats["relax_dispatches"] = 1
            self.stats["ladder_rungs_used"] = lad["rungs"]
            final = canonicalize_placements(qinp, res)
            # same frame rule as _relax_solve (the ladder enc carries ghost
            # rung groups); the rung count is a leg annotation
            self._capture(qinp, final,
                          annotations={"relax_dispatches": 1, "ladder_rungs": lad["rungs"]})
            return final
        dropped = {u: 0 for u in items_map}
        return self._relax_solve(qinp, items_map, order, dropped, None)

    # -- device path ----------------------------------------------------------

    def _upload(self, host_args: tuple, prov: tuple, ns=None, stage: bool = False) -> tuple:
        """The kernel args on the device: adopted by the arena (only stale
        entries, one packed upload), or per array with arena=False. With
        `stage` (a single solve's upload) and stream_run_events on, the run
        tables first sync through the edit-triplet scatter; a declined stage
        leaves adopt's normal packed upload, so the same bytes land."""
        if self.arena is not None:
            if stage and self.stream_run_events:
                staged = self.arena.apply_run_events(host_args, prov, ns=ns)
                self.stats["event_stage_hits" if staged else "event_stage_misses"] += 1
            return self.arena.adopt(host_args, prov, ns=ns)
        return self._device_args(host_args, prov)

    def _device_args(self, host_args: tuple, prov: tuple) -> tuple:
        """Per-array upload (arena=False): one message per array not in
        the static-array cache."""
        from .convert import array_to_torch

        out = []
        up_bytes = up_arrays = 0
        for a, tok in zip(host_args, prov):
            hit = self._dev_cache.get(tok) if tok is not None else None
            if hit is None:
                hit = array_to_torch(a, self.device)
                up_bytes += a.nbytes
                up_arrays += 1
                if tok is not None:
                    while len(self._dev_cache) >= 128:
                        self._dev_cache.pop(next(iter(self._dev_cache)))
                    self._dev_cache[tok] = hit
            out.append(hit)
        self.ledger.record_upload(up_bytes, up_arrays, msgs=up_arrays)
        return tuple(out)

    def _sparse_gate(self, enc: EncodedInput) -> bool:
        """Whether this solve evaluates constraints through the compacted
        V/Q index tables."""
        if self.sparse == "off":
            return False
        if self.sparse == "on":
            return (enc.Q + enc.V) > 0
        return use_sparse_constraints(enc)

    def _sparse_arg(self, host_args, enc: EncodedInput, run_q_idx: np.ndarray,
                    run_v_idx: np.ndarray, ns=None):
        """Upload (or reuse) the sparse index pair: with the arena a
        per-bucket residency class whose token is the encode core rev plus
        the tables' digests (two messages when it uploads)."""
        from .convert import array_to_torch

        key = None
        if self.arena is not None:
            key = self.arena.bucket_key(host_args, ns=ns)
            dev = self.arena.get_sparse(key, enc.core_rev, run_q_idx, run_v_idx)
            if dev is not None:
                return dev
        dev = (array_to_torch(run_q_idx, self.device), array_to_torch(run_v_idx, self.device))
        self.ledger.record_upload(run_q_idx.nbytes + run_v_idx.nbytes, 2, msgs=2)
        if key is not None:
            self.arena.put_sparse(key, enc.core_rev, run_q_idx, run_v_idx, dev)
        return dev

    def _dispatch(self, args, M: int, total_pods: int, zone_engine: bool, ladder=None,
                  harvest: bool = False, sparse=None):
        """Scan + output packing: the ladder scan when `ladder` holds a rung
        table, the checkpointed scan when `harvest` (and resume) asks for a
        ring, else the plain scan; each through its sparse twin when
        `sparse` holds the device index pair. Returns (flat device buffer,
        unpack fn, FFDOutput, CheckpointRing or None)."""
        from .cuda import ffd

        ring = None
        kw = dict(max_claims=M, zone_engine=zone_engine)
        ring_kw = dict(ckpt_every=self.ckpt_every, n_ckpt=self.ckpt_slots)
        if sparse is not None:
            self.stats["sparse_dispatches"] += 1
            if ladder is not None:
                out = ffd.ffd_solve_ladder_sparse(ladder, *sparse, *args, **kw)
            elif harvest and self.resume:
                out, ring = ffd.ffd_solve_ckpt_sparse(*sparse, *args, **kw, **ring_kw)
            else:
                out = ffd.ffd_solve_sparse(*sparse, *args, **kw)
        elif ladder is not None:
            out = ffd.ffd_solve_ladder(ladder, *args, **kw)
        elif harvest and self.resume:
            out, ring = ffd.ffd_solve_ckpt(*args, **kw, **ring_kw)
        else:
            out = ffd.ffd_solve(*args, **kw)
        flat_dev, unpack = self._pack_dispatch(out, total_pods)
        return flat_dev, unpack, out, ring

    def _pack_dispatch(self, out, total_pods: int):
        """The dispatch's one packed output buffer and its host-side unpack,
        which re-fetches wide on overflow: the claim delta, or the dense
        output pack with device_decode=False or past the delta's uint16
        run/target coding (65535 runs, a node+claim axis of 65536)."""
        Sp, Ep = out.take_e.shape
        Mb, Tp = out.state.c_mask.shape
        Wm = (Tp + 31) // 32
        Wg = out.state.c_gbits.shape[1]
        Rr = out.state.c_cum.shape[1]
        wide_shapes = {
            "take_e": ((Sp, Ep), "i32"),
            "take_c": ((Sp, Mb), "i32"),
            "leftover": ((Sp,), "i32"),
            "c_mask_words": ((Mb, Wm), "u32"),
            "c_zc_bits": ((Mb,), "u32"),
            "c_gbits": ((Mb, Wg), "u32"),
            "c_pool": ((Mb,), "i32"),
            "c_cum": ((Mb, Rr), "i32"),
            "used": ((), "i32"),
        }

        def refetch_wide() -> dict:
            self.stats["wide_refetches"] += 1
            return _unpack_flat(self._fetch(_pack_outputs_wide(out)), wide_shapes)

        if not (self.device_decode and Sp <= 65535 and Ep + Mb <= 65535):
            tail_shapes = {k: wide_shapes[k] for k in list(wide_shapes)[2:]}

            def unpack_dense(flat: np.ndarray) -> dict:
                if flat[0]:  # a take past uint16 — re-fetch wide
                    return refetch_wide()
                off, f = 1, {}
                for name in ("take_e", "take_c"):
                    shape = wide_shapes[name][0]
                    n = shape[0] * shape[1]
                    w = (n + 1) // 2
                    f[name] = flat[off : off + w].view(np.uint16)[:n].astype(np.int32).reshape(shape)
                    off += w
                f.update(_unpack_flat(flat[off:], tail_shapes))
                return f

            return _pack_outputs(out), unpack_dense

        cap = delta_capacity(total_pods, Sp, Ep, Mb)
        cap_u = delta_uniq_capacity(Sp, Mb)
        Wt = Wm + 1 + Wg + 1  # meta row: cm_words ++ zc ++ gbits ++ pool

        def unpack(flat: np.ndarray) -> dict:
            if flat[0]:  # uint16/capacity overflow — re-fetch wide (rare)
                return refetch_wide()
            n = int(flat[1])
            off = 3
            cnt = flat[off : off + Sp // 2].view(np.uint16)[:Sp]
            off += Sp // 2
            pairs = flat[off : off + cap].view(np.uint16).reshape(cap, 2)
            off += cap
            leftover = flat[off : off + Sp]
            off += Sp
            uniq = flat[off : off + cap_u * Wt].view(np.uint32).reshape(cap_u, Wt)
            off += cap_u * Wt
            mid = flat[off : off + Mb // 2].view(np.uint16)[:Mb]
            off += Mb // 2
            used = flat[off]
            s_col = np.repeat(np.arange(Sp, dtype=np.int64), cnt.astype(np.int64))
            entries = np.stack(
                [
                    s_col,
                    pairs[:n, 0].astype(np.int64),
                    pairs[:n, 1].astype(np.int64),
                ],
                axis=1,
            )
            meta = uniq[np.minimum(mid.astype(np.int64), cap_u - 1)]
            c_pool = np.ascontiguousarray(meta[:, Wt - 1]).view(np.int32)
            return {
                "entries": entries,
                "Ep": Ep,
                "leftover": leftover,
                "c_mask_words": meta[:, :Wm],
                "c_zc_bits": np.ascontiguousarray(meta[:, Wm]),
                "c_gbits": np.ascontiguousarray(meta[:, Wm + 1 : Wm + 1 + Wg]),
                "c_pool": c_pool,
                "used": used,
            }

        return _pack_outputs_delta(out, cap, cap_u), unpack

    def _fetch(self, flat_dev: torch.Tensor) -> np.ndarray:
        flat = flat_dev.cpu().numpy()
        self.ledger.record_fetch(flat.nbytes)
        return flat

    def _device_explain(self, enc: EncodedInput, out):
        """Dispatch the explain side kernel (cuda/ffd.py explain_pack, K12)
        over the solve's device-resident take table plus the host-built side
        tables (encode.explain_tables), fetch the int32 wire buffer through
        the transfer ledger, and decode the real-group prefix. Returns
        (n_rejected, words), or None when the node axis overflows the uint16
        entry half: the host deriver rebuilds the table at full width."""
        from .convert import array_to_torch
        from .cuda.ffd import explain_pack, unpack_explain

        take_e = out.take_e
        Sp, Ep = int(take_e.shape[0]), int(take_e.shape[1])
        if Ep > 0xFFFF:
            self.stats["explain_wide"] += 1
            return None
        side, E, G = explain_args(enc, Sp, Ep)
        dev = [array_to_torch(a, self.device) for a in side]
        flat = self._fetch(explain_pack(take_e, *dev, E, G, top_k=obsexplain.top_k()))
        self.stats["explain_dispatches"] += 1
        overflow, n_rej, words = unpack_explain(flat, G)
        if overflow:
            self.stats["explain_wide"] += 1
            return None
        return n_rej, words

    def _stash_explain(self, enc: EncodedInput, res: SolverResult, out, plan) -> None:
        """Cold dispatches only: a resumed solve's take table is stitched on
        the host, so the device rows alone would disagree with the final
        decisions; those solves host-derive. The table rides the result as
        a plain attribute for solve_async's capture."""
        if plan is not None or not obsexplain.enabled():
            return
        tbl = self._device_explain(enc, out)
        if tbl is not None:
            res._explain_table = tbl

    def _device_solve_async(self, enc: EncodedInput):
        try:
            host_args, dims, prov = host_kernel_args(enc, self._bucket)
        except UnpackableInput as e:
            raise UnsupportedInput(str(e)) from e
        # the zoned branch runs only when the solve has V-axis sigs, as in
        # the JAX backend (zone_engine=enc.V > 0)
        zone = enc.V > 0
        check_kernel_limits(dims, host_args, zone, self.device)
        # the ledger's per-solve window: every byte of this solve's upload
        # and fetches (closed in finish)
        self.ledger.begin_solve()
        args = self._upload(host_args, prov, enc.tenant_id, stage=True)
        sparse_host = sparse = None
        if self._sparse_gate(enc):
            sparse_host = sparse_run_tables(enc, dims["Sp"])
            sparse = self._sparse_arg(host_args, enc, *sparse_host, ns=enc.tenant_id)
        S = dims["S"]
        total_pods = int(sum(len(p) for p in enc.group_pods))
        # claim slots sized from the input, doubled on saturation; the
        # redispatch reuses the resident args
        M0 = initial_claim_bucket(total_pods, self.max_claims)
        plan = self._plan_resume(enc, host_args, M0, S)
        if plan is not None:
            flat_dev, unpack, out, ring = self._dispatch_resume(
                enc, args, host_args, plan, M0, S, total_pods, sparse_host)
        else:
            flat_dev, unpack, out, ring = self._dispatch(
                args, M0, total_pods, zone, harvest=True, sparse=sparse)

        def finish() -> SolverResult:
            try:
                res = self._collect(enc, dims, args, flat_dev, unpack, M0, total_pods, zone,
                                    plan=plan, out=out, ring=ring, host_args=host_args,
                                    sparse=sparse)
            finally:
                self.ledger.end_solve()
            if res is None:
                raise UnsupportedInput(
                    f"the solve needs more than max_claims={self.max_claims} claims"
                )
            return res

        return finish

    # -- checkpointed-scan resume ----------------------------------------------

    def _plan_resume(self, enc: EncodedInput, host_args, M0: int, S: int):
        """The newest valid checkpoint for this dispatch, or None.

        Prefix validity: (a) a record exists for the CURRENT arena bucket
        (same padded shapes as the donor), (b) every non-run kernel arg is
        byte-identical to the donor's (the arena's context signature), (c)
        the donor and current run lists share a prefix of (snum, group,
        count) triples, shorter than the whole list (an identical list is
        the exact-hit cold path, which uploads nothing), (d) the donor's
        claim bucket and zone-engine flag match this dispatch. The chosen
        checkpoint covers the most runs within the common prefix; the
        donor's final state (its whole run list) wins on pure appends."""
        if not self.resume or self.arena is None:
            return None
        from . import encode_cache as ec

        run_idx = (ARG_INDEX["run_group"], ARG_INDEX["run_count"])
        key = self.arena.bucket_key(host_args, ns=enc.tenant_id)
        recs = self.arena.get_checkpoints(key)
        if not recs:
            return None
        rec = recs[0]
        if rec["M"] != M0 or rec["zone_engine"] != (enc.V > 0):
            return None
        ctx = self.arena.context_signature(key, exclude=run_idx)
        if ctx is None or ctx != rec["ctx_sig"]:
            return None  # node/pool/core tables moved since the donor solve
        cur = ec.run_identity(enc)
        if not cur or len(cur) != S:
            return None  # signatures not interned: prefixes not comparable
        lcp = ec.run_lcp(rec["run_ident"], cur)
        if lcp < 1 or lcp == len(cur) == len(rec["run_ident"]):
            return None
        if rec["final_covered"] <= lcp:
            k, init = rec["final_covered"], rec["final_state"]
        else:
            cand = None
            for covered, slot in rec["ring_covered"]:
                if 1 <= covered <= lcp and (cand is None or covered > cand[0]):
                    cand = (covered, slot)
            if cand is None or rec["ring"] is None:
                return None
            k, slot = cand
            init = type(rec["final_state"])(*(f[slot] for f in rec["ring"].states))
        return {"k": k, "init": init, "rec": rec}

    def _dispatch_resume(self, enc: EncodedInput, args, host_args, plan, M: int, S: int,
                         total_pods: int, sparse_host=None):
        """Dispatch only runs[k:] on top of the planned checkpoint: the
        non-run args are the arena's resident tensors, and only the two
        suffix run arrays cross (under the sparse gate also their index
        rows, two more messages). ffd_resume starts from copies of the
        checkpoint, so the donor record stays intact."""
        from .convert import array_to_torch
        from .cuda.ffd import ffd_resume, ffd_resume_sparse

        k = plan["k"]
        Sp2 = self._bucket(S - k, 16, 16)
        sg = np.zeros((Sp2,), host_args[0].dtype)
        sc = np.zeros((Sp2,), host_args[1].dtype)
        sg[: S - k] = np.asarray(host_args[0])[k:S]
        sc[: S - k] = np.asarray(host_args[1])[k:S]
        dev_sg = array_to_torch(sg, self.device)
        dev_sc = array_to_torch(sc, self.device)
        self.ledger.record_upload(sg.nbytes + sc.nbytes, 2, msgs=2)
        kw = dict(max_claims=M, zone_engine=enc.V > 0, ckpt_every=self.ckpt_every,
                  n_ckpt=self.ckpt_slots)
        if sparse_host is not None:
            rqi, rvi = sparse_host
            sq = np.full((Sp2, rqi.shape[1]), -1, rqi.dtype)
            sv = np.full((Sp2, rvi.shape[1]), -1, rvi.dtype)
            sq[: S - k] = rqi[k:S]
            sv[: S - k] = rvi[k:S]
            dev_sq, dev_sv = array_to_torch(sq, self.device), array_to_torch(sv, self.device)
            self.ledger.record_upload(sq.nbytes + sv.nbytes, 2, msgs=2)
            self.stats["sparse_dispatches"] += 1
            out, ring = ffd_resume_sparse(plan["init"], dev_sq, dev_sv, dev_sg, dev_sc,
                                          *args[2:], **kw)
        else:
            out, ring = ffd_resume(plan["init"], dev_sg, dev_sc, *args[2:], **kw)
        flat_dev, unpack = self._pack_dispatch(out, total_pods)
        return flat_dev, unpack, out, ring

    def _ring_coverage(self, Sp: int, S_real: int, base: int):
        """Which REAL-run prefix each ring slot covers, recomputed from the
        slot schedule alone (step j*K writes slot (j-1) % n; the last write
        wins; padded steps past S_real leave the state as it is, so a
        checkpoint at position p covers min(p, S_real) real runs). The ring's
        prefix is never fetched."""
        K, n = self.ckpt_every, self.ckpt_slots
        cov: Dict[int, int] = {}
        for j in range(1, Sp // K + 1):
            cov[(j - 1) % n] = base + min(j * K, S_real)
        return sorted(((c, s) for s, c in cov.items()), reverse=True)

    def _record_checkpoint(self, enc: EncodedInput, host_args, M: int, S: int, plan, out,
                           ring, take_e_p, take_c_p, leftover_p) -> None:
        """After a device solve, record its checkpoints as the bucket's
        resume donor: run identity, the host-side take rows (a resumed
        successor needs prefix rows it will not re-execute), and the
        device-resident ring and final state (never fetched)."""
        if not self.resume or self.arena is None or out is None:
            return
        from . import encode_cache as ec

        ident = ec.run_identity(enc)
        if not ident or len(ident) != S:
            return
        key = self.arena.bucket_key(host_args, ns=enc.tenant_id)
        ctx = self.arena.context_signature(
            key, exclude=(ARG_INDEX["run_group"], ARG_INDEX["run_count"])
        )
        if ctx is None:
            return
        if plan is not None:
            base, suffix_real = plan["k"], S - plan["k"]
            Sp_disp = self._bucket(suffix_real, 16, 16)
        else:
            base, suffix_real = 0, S
            Sp_disp = int(host_args[0].shape[0])
        self.arena.put_checkpoint(key, {
            "run_ident": ident,
            "take_e": np.asarray(take_e_p),
            "take_c": np.asarray(take_c_p),
            "leftover": np.asarray(leftover_p),
            "M": M,
            "zone_engine": enc.V > 0,
            "ctx_sig": ctx,
            "ring": ring,
            "ring_covered": self._ring_coverage(Sp_disp, suffix_real, base),
            "final_state": out.state,
            "final_covered": S,
        })

    def _collect(self, enc: EncodedInput, dims: dict, args, flat_dev, unpack, M0: int,
                 total_pods: int, zone: bool, ladder=None, plan=None, out=None, ring=None,
                 host_args=None, sparse=None) -> Optional[SolverResult]:
        """Fetch + decode one dispatch, doubling the claim bucket (a
        redispatch on the resident args) while the solve fills it. None when
        the solve needs more than max_claims claims. A resumed dispatch
        (`plan`) stitches the donor's prefix rows in front of its suffix
        rows; one that saturated its claim slots no longer matches the
        donor's M, so the retry replays cold. With `host_args` (a single
        solve, not the ladder) the solve is recorded as the bucket's resume
        donor."""
        M = M0
        flat, up = self._fetch(flat_dev), unpack
        while True:
            f = up(flat)
            used = int(f["used"])
            if used < M:
                break
            plan = None
            if M >= self.max_claims:
                return None
            M = min(M * 2, self.max_claims)
            self.stats["claim_doublings"] += 1
            fd, up, out, ring = self._dispatch(args, M, total_pods, zone, ladder=ladder,
                                               harvest=True, sparse=sparse)
            flat = self._fetch(fd)
        return self._decode_fetched(enc, dims, f, M, used, plan, out, ring, host_args)

    def _decode_fetched(self, enc: EncodedInput, dims: dict, f: dict, M: int, used: int,
                        plan=None, out=None, ring=None, host_args=None) -> SolverResult:
        """Decode one unpacked fetch whose claims fit the bucket M: the
        delta entries (a resumed dispatch's stitched behind the donor's
        prefix rows) or the wide tables. With `host_args` (a single solve)
        the solve is recorded as the bucket's resume donor and its explain
        table stashed."""
        S, E, T, G = dims["S"], dims["E"], dims["T"], dims["G"]
        Z, C = dims["Z"], dims["C"]
        c_mask = _unpack_words(f["c_mask_words"], T)
        c_zone, c_ct = unpack_zc_bits(f["c_zc_bits"], Z, C)
        c_gmask = _unpack_gmask(f["c_gbits"], G)
        k = plan["k"] if plan is not None else 0
        if plan is not None:
            self.stats["resume_solves"] += 1
            self.stats["resume_runs_skipped"] += k
        if "entries" in f:
            # the take tables never crossed: a resumed dispatch splices the
            # donor's recorded prefix rows in as triples (suffix runs shift
            # by k). Rung pours charge the base group's requests (relaxation
            # drops preferences, never resources), so the c_cum rebuild over
            # run_group is exact on the ladder too.
            Ep_ = f["Ep"]
            entries = f["entries"]
            if plan is not None:
                rec = plan["rec"]
                entries = entries.astype(np.int64)
                entries[:, 0] += k
                entries = np.concatenate(
                    [_entries_from_dense(rec["take_e"][:k], rec["take_c"][:k], Ep_), entries])
            leftover = _stitch(plan, "leftover", f["leftover"], S)
            c_cum = _claim_cum_from_entries(enc, entries, f["c_pool"], Ep_, M)
            res = decode_delta(enc, entries, leftover, E, Ep_, c_mask, c_zone, c_ct,
                               f["c_pool"], c_gmask, c_cum, used)
            if host_args is not None and self.resume:
                # the donor record stays dense: rebuild the rows
                take_e, take_c = _dense_from_entries(entries, S, Ep_, M)
                self._record_checkpoint(enc, host_args, M, S, plan, out, ring, take_e,
                                        take_c, leftover)
            if host_args is not None:
                self._stash_explain(enc, res, out, plan)
            return res
        # the wide re-fetch: rows [0:k] are the donor record's, rows [k:S]
        # this dispatch's; the final state needs no stitching
        take_e = _stitch(plan, "take_e", f["take_e"], S)
        take_c = _stitch(plan, "take_c", f["take_c"], S)
        leftover = _stitch(plan, "leftover", f["leftover"], S)
        res = decode(enc, take_e[:, :E], take_c, leftover, c_mask, c_zone, c_ct, f["c_pool"],
                     c_gmask, f["c_cum"], used)
        if host_args is not None:
            self._record_checkpoint(enc, host_args, M, S, plan, out, ring, take_e, take_c,
                                    leftover)
            self._stash_explain(enc, res, out, plan)
        return res


def explain_args(enc: EncodedInput, Sp: int, Ep: int):
    """The explain side kernel's tables (cuda/ffd.py EXPLAIN_ARG_SPEC after
    take_e, before the counts) for a dispatch of padded shape [Sp, Ep]:
    (tables, E, G). The group axis pads to a power of two; Z/C widths pad to
    >= 1 with all-False columns, the rule the numpy twin applies, so the
    tables are bit-equal."""
    t = explain_tables(enc)
    G = int(t["group_req"].shape[0])
    E = int(t["node_free"].shape[0])
    R = int(t["group_req"].shape[1])
    S = int(t["run_group"].shape[0])
    Gp = 1 << (max(G, 1) - 1).bit_length()
    gz = np.asarray(t["group_zone"], bool).reshape(G, -1)
    gc = np.asarray(t["group_ct"], bool).reshape(G, -1)
    Z, C = max(1, gz.shape[1]), max(1, gc.shape[1])
    run_group = np.zeros(Sp, dtype=np.int32)
    run_group[:S] = t["run_group"]
    group_req = np.zeros((Gp, R), dtype=np.int32)
    group_req[:G] = t["group_req"]
    node_free = np.zeros((Ep, R), dtype=np.int32)
    node_free[:E] = t["node_free"]
    node_compat = np.zeros((Gp, Ep), dtype=bool)
    node_compat[:G, :E] = t["node_compat"]
    node_zone = np.full(Ep, -1, dtype=np.int32)
    node_zone[:E] = t["node_zone"]
    node_ct = np.full(Ep, -1, dtype=np.int32)
    node_ct[:E] = t["node_ct"]
    group_zone = np.zeros((Gp, Z), dtype=bool)
    group_zone[:G, : gz.shape[1]] = gz
    group_ct = np.zeros((Gp, C), dtype=bool)
    group_ct[:G, : gc.shape[1]] = gc
    group_topo = np.zeros(Gp, dtype=bool)
    group_topo[:G] = t["group_topo"]
    group_aff = np.zeros(Gp, dtype=bool)
    group_aff[:G] = t["group_aff"]
    return ((run_group, group_req, node_free, node_compat, node_zone, node_ct, group_zone,
             group_ct, group_topo, group_aff), E, G)


def _stitch(plan, name: str, rows: np.ndarray, S: int) -> np.ndarray:
    """The S real rows of a fetched table: this dispatch's alone, or after a
    resume the donor's first k rows followed by the suffix's S - k."""
    if plan is None:
        return rows[:S]
    k = plan["k"]
    return np.concatenate([plan["rec"][name][:k], rows[: S - k]])


def _empty_result() -> SolverResult:
    return SolverResult(placements={}, claims=[], errors={})


def _check_encode(enc: EncodedInput) -> None:
    """Raise UnsupportedInput for an encode the device path cannot solve."""
    if enc.group_fallback.any():
        raise UnsupportedInput("fallback groups need the oracle")
    if enc.has_topology or enc.has_affinity:
        raise UnsupportedInput("custom-key topology/affinity needs the oracle")


def _unpack_words(words: np.ndarray, width: int) -> np.ndarray:
    """[N, W] uint32 words -> [N, width] bool (inverse of bit-packing)."""
    N, W = words.shape
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1
    return bits.reshape(N, W * 32)[:, :width].astype(bool)


def _unpack_gmask(gbits: np.ndarray, G: int) -> np.ndarray:
    """[M, W] uint32 words -> [M, G] bool group-membership mask."""
    return _unpack_words(gbits, G)


def decode(
    enc: EncodedInput,
    take_e: np.ndarray,  # [S, E]
    take_c: np.ndarray,  # [S, M]
    leftover: np.ndarray,  # [S]
    c_mask: np.ndarray,  # [M, T]
    c_zone: np.ndarray,  # [M, Z]
    c_ct: np.ndarray,  # [M, C]
    c_pool: np.ndarray,  # [M]
    c_gmask: np.ndarray,  # [M, G]
    c_cum: np.ndarray,  # [M, R]
    used: int,
) -> SolverResult:
    """Reassemble a SolverResult from dense take tables: pods assigned in
    index order per run (existing nodes first, then claim slots)."""
    S = len(enc.run_group)
    E = take_e.shape[1] if take_e.ndim == 2 else 0
    segs: List[np.ndarray] = []
    for s in range(S):
        te, tc, lo = take_e[s], take_c[s], int(leftover[s])
        parts: List[np.ndarray] = []
        e_idx = np.flatnonzero(te)
        if e_idx.size:
            parts.append(np.repeat(e_idx, te[e_idx]))
        c_idx = np.flatnonzero(tc)
        if c_idx.size:
            parts.append(np.repeat(c_idx + E, tc[c_idx]))
        if lo:
            parts.append(np.full(lo, -1, np.int64))
        if parts:
            segs.append(np.concatenate([p.astype(np.int64, copy=False) for p in parts]))
    codes = np.concatenate(segs) if segs else np.zeros(0, np.int64)
    return _decode_from_codes(
        enc, codes, E, c_mask, c_zone, c_ct, c_pool, c_gmask, c_cum, used
    )


def decode_delta(
    enc: EncodedInput,
    entries: np.ndarray,  # [n, 3] (run, code, count), code = e | Ep+m
    leftover: np.ndarray,  # [S]
    E: int,  # unpadded node count
    Ep: int,  # padded node axis the device codes split on
    c_mask: np.ndarray,
    c_zone: np.ndarray,
    c_ct: np.ndarray,
    c_pool: np.ndarray,
    c_gmask: np.ndarray,
    c_cum: np.ndarray,
    used: int,
) -> SolverResult:
    """Rebuild decode()'s exact codes stream from the packed claim-delta:
    within a run, node codes sort before claim codes before the leftover
    row (sentinel key) — decode()'s per-run emission order."""
    S = len(enc.run_group)
    s = entries[:, 0].astype(np.int64)
    cd = entries[:, 1].astype(np.int64)
    v = entries[:, 2].astype(np.int64)
    keep = (s < S) & (v > 0)
    s, cd, v = s[keep], cd[keep], v[keep]
    code = np.where(cd >= Ep, cd - Ep + E, cd)
    lo = leftover[:S].astype(np.int64)
    ls = np.flatnonzero(lo)
    SENT = np.int64(np.iinfo(np.int64).max)
    s_all = np.concatenate([s, ls])
    code_all = np.concatenate([code, np.full(ls.size, SENT)])
    v_all = np.concatenate([v, lo[ls]])
    order = np.lexsort((code_all, s_all))
    codes = np.repeat(
        np.where(code_all[order] == SENT, np.int64(-1), code_all[order]),
        v_all[order],
    )
    return _decode_from_codes(
        enc, codes, E, c_mask, c_zone, c_ct, c_pool, c_gmask, c_cum, used
    )


def _claim_cum_from_entries(enc: EncodedInput, entries: np.ndarray,
                            c_pool: np.ndarray, Ep: int,
                            Mb: int) -> np.ndarray:
    """Rebuild the kernel's c_cum [M, R] from the claim-delta: pool daemon
    base on open, + take × group_req per pour, in int32 wraparound."""
    R = enc.group_req.shape[1]
    cum = np.zeros((Mb, R), dtype=np.int64)
    pool = np.asarray(c_pool[:Mb]).astype(np.int64)
    opened = pool >= 0
    cum[opened] = enc.pool_daemon[pool[opened]].astype(np.int64)
    s = entries[:, 0].astype(np.int64)
    cd = entries[:, 1].astype(np.int64)
    v = entries[:, 2].astype(np.int64)
    csel = (cd >= Ep) & (cd - Ep < Mb) & (s < len(enc.run_group))
    if csel.any():
        m = cd[csel] - Ep
        g = enc.run_group[s[csel]].astype(np.int64)
        np.add.at(cum, m, v[csel, None] * enc.group_req[g].astype(np.int64))
    return cum.astype(np.int32)  # int64 -> int32 truncation == device wrap


def _entries_from_dense(take_e: np.ndarray, take_c: np.ndarray, Ep: int) -> np.ndarray:
    """Dense take rows -> (run, code, count) triples in the device coding
    (claims offset by the PADDED node axis). Splices a resume donor's
    recorded prefix rows into a delta-decoded suffix."""
    rs, cs = np.nonzero(take_e)
    rs2, cs2 = np.nonzero(take_c)
    return np.concatenate(
        [
            np.stack([rs, cs, take_e[rs, cs]], axis=1),
            np.stack([rs2, cs2 + Ep, take_c[rs2, cs2]], axis=1),
        ]
    ).astype(np.int64)


def _dense_from_entries(entries: np.ndarray, S: int, Ep: int,
                        Mb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of the compaction for the checkpoint record: a resume donor
    stores dense take rows."""
    take_e = np.zeros((S, Ep), np.int32)
    take_c = np.zeros((S, Mb), np.int32)
    s = entries[:, 0].astype(np.int64)
    cd = entries[:, 1].astype(np.int64)
    v = entries[:, 2].astype(np.int64)
    keep = s < S
    s, cd, v = s[keep], cd[keep], v[keep]
    node = cd < Ep
    take_e[s[node], cd[node]] = v[node]
    take_c[s[~node], cd[~node] - Ep] = v[~node]
    return take_e, take_c


def _decode_from_codes(
    enc: EncodedInput,
    codes: np.ndarray,  # [total_pods] int64: node e -> e, claim m -> E+m, -1
    E: int,
    c_mask: np.ndarray,  # [M, T]
    c_zone: np.ndarray,  # [M, Z]
    c_ct: np.ndarray,  # [M, C]
    c_pool: np.ndarray,  # [M]
    c_gmask: np.ndarray,  # [M, G]
    c_cum: np.ndarray,  # [M, R]
    used: int,
) -> SolverResult:
    """Shared tail of decode()/decode_delta(): codes stream (aligned with
    enc.sorted_uids) -> SolverResult."""
    uid_sorted = enc.sorted_uids
    targets = np.empty(E + used, dtype=object)
    for e in range(E):
        targets[e] = ("node", enc.node_ids[e])
    for m in range(used):
        targets[E + m] = ("claim", m)

    ok = codes >= 0
    placements: Dict[str, Tuple[str, object]] = dict(
        zip(uid_sorted[ok].tolist(), targets[codes[ok]].tolist())
    )
    errors: Dict[str, str] = dict.fromkeys(
        uid_sorted[~ok].tolist(), "no instance type in any nodepool satisfies the pod"
    )
    ccodes = codes - E
    csel = ccodes >= 0
    cc = ccodes[csel]
    cuids = uid_sorted[csel][np.argsort(cc, kind="stable")]
    offs = np.concatenate(([0], np.cumsum(np.bincount(cc, minlength=used)))) if used else np.zeros(1, np.int64)
    claim_pods: Dict[int, List[str]] = {
        m: cuids[offs[m] : offs[m + 1]].tolist() for m in range(used)
    }

    # claim templates dedupe by identity row (pool, zone/ct/group/type bits)
    claims: List[ClaimResult] = []
    if used:
        key_rows = np.concatenate(
            [
                np.ascontiguousarray(c_pool[:used].astype(">i4")).view(np.uint8).reshape(used, 4),
                np.packbits(c_zone[:used], axis=1),
                np.packbits(c_ct[:used], axis=1),
                np.packbits(c_gmask[:used], axis=1),
                np.packbits(c_mask[:used], axis=1),
            ],
            axis=1,
        )
        _, tmpl_first, tmpl_of = np.unique(
            key_rows, axis=0, return_index=True, return_inverse=True
        )
        tmpl_of = tmpl_of.ravel()
        templates = {}
        for ti, m0 in enumerate(tmpl_first):
            m0 = int(m0)
            pool_name = enc.pool_names[int(c_pool[m0])]
            type_names = [enc.type_names[t] for t in np.flatnonzero(c_mask[m0])]
            reqs = Requirements.of(
                Requirement.create(wk.NODEPOOL_LABEL, IN, [pool_name])
            )
            zones = [enc.zones[z] for z in np.flatnonzero(c_zone[m0])]
            cts = [enc.capacity_types[c] for c in np.flatnonzero(c_ct[m0])]
            if zones:
                reqs.add(Requirement.create(wk.ZONE_LABEL, IN, zones))
            if cts:
                reqs.add(Requirement.create(wk.CAPACITY_TYPE_LABEL, IN, cts))
            for g in np.flatnonzero(c_gmask[m0]):
                reqs = reqs.union(enc.group_pods[int(g)][0].scheduling_requirements())
            templates[ti] = (pool_name, type_names, reqs)
        mult = np.fromiter(
            (
                1024**2 if k in ("memory", "ephemeral-storage") else 1
                for k in enc.resource_keys
            ),
            np.int64,
            len(enc.resource_keys),
        )
        vals = c_cum[:used].astype(np.int64) * mult[None, :]
        rkeys = enc.resource_keys
        for m in range(used):
            pool_name, type_names, reqs = templates[int(tmpl_of[m])]
            row = vals[m]
            requests = Resources()
            for i, v in enumerate(row.tolist()):
                if v:
                    requests[rkeys[i]] = v
            claims.append(
                ClaimResult(
                    nodepool=pool_name,
                    requirements=reqs,
                    instance_type_names=type_names,
                    pod_uids=claim_pods[m],
                    requests=requests,
                    taints=[],
                    hostname=f"claim-{m}",
                )
            )
    return SolverResult(placements=placements, claims=claims, errors=errors)
