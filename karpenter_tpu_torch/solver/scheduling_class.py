# Port copy of karpenter_tpu/solver/scheduling_class.py (metric counters and
# trace spans left out).
"""Scheduling classes: priority, preemption, and gang scheduling.

The subsystem that makes `pod.priority` and the gang labels
(api/wellknown.py GANG_*) mean something end to end:

- **Ordering** lives in the canonical sort (provisioning/scheduler.py
  ffd_sort_with_sigs): priority-major, gang-contiguous — `(priority desc,
  gang_id, existing FFD key)` — shared by every backend, so the base
  kernels stay class-blind.
- **Atomic gangs** and **preemption** are post-scan passes orchestrated here
  around ANY inner solver. The decision math runs through a *planner* with
  three bit-identical implementations — the python oracle, the numpy host
  mirror and the device leg (cuda/ffd.py gang_commit and preemption_walk:
  the K10 and walk kernels on the card, their plain versions on the CPU) —
  selected by the concrete backend at the bottom of the wrapper chain. The
  oracle and host legs plan preemptions one candidate at a time; the
  device leg walks a chunk of candidates a call (every candidate in one
  call where they share their node rows) over tables uploaded once.

Gang rollback semantics: a sequential deterministic scan means "roll back to
the pre-gang carry and continue" is EXACTLY "re-solve with the gang's pods
stripped" — decisions before the gang's first run are unaffected (the scan
never looks ahead), and decisions after see the same carry either way. The
orchestrator therefore strips the first failing gang in scan order and
re-solves, at most once per gang; TorchSolver's suffix resume replays only
from the stripped gang's position when the run lists share a prefix.

Preemption semantics: after gangs settle, each still-unplaced pod (class-FFD
order) may claim capacity from strictly-lower-priority bound pods on
existing nodes. The planner picks the first node (ascending input order)
where free + the minimal prefix of its eligible victims — ascending
(priority, uid), so the least important evict first — covers the pod's
quantized request. Victims are planned as `SolverResult.evictions`; the
pending pod schedules on a later reconcile once the capacity frees.

Declines (counted in `class_stats["declines"]`): preemption with an active
topology/affinity engine (evictions would invalidate V/Q domain counts
mid-plan), eviction tables overflowing the uint16 wire format, more
evictions than MAX_EVICTIONS_PER_SOLVE in one solve, and gangs larger than
the claim budget.

Off-path inertness: with the knobs off — or on any priority-flat, gang-free
fleet — `ClassAwareSolver` delegates verbatim (same object path, zero
re-ordering), so those solves are bit-identical to the inner solver's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import wellknown as wk
from ..api.objects import Pod, PodAffinityTerm, tolerates_all
from ..obs import explain as obsexplain
from ..provisioning.scheduler import Eviction, SolverInput, SolverResult, ffd_sort
from ..scheduling.requirements import Requirements
from ..utils.resources import PODS

# Module knobs (the reference operator sets them from --solver-preemption /
# --solver-gang); ffd_sort_with_sigs consults them too, so flipping one off
# removes BOTH the ordering keys and the pass it gates.
PRIORITY_ENABLED = True
GANG_ENABLED = True

# A gang needing more placements than one solve's claim budget can never
# commit atomically — declined up front (counted), not half-placed.
GANG_CLAIM_BUDGET = 4096
# Eviction-storm guard: one solve plans at most this many evictions; the
# remainder declines to the next reconcile (counted).
MAX_EVICTIONS_PER_SOLVE = 256

INT32_MAX = 2**31 - 1

# The preemption pass walks its candidates a chunk at a time: a chunk runs
# through the candidate before its WALK_CHUNK_KEYS + 1-th mask_key not seen
# in an earlier chunk. A pass the budget stops early so builds node rows for
# at most WALK_CHUNK_KEYS - 1 candidates past the ones it walked; candidates
# that share one key are one chunk. At 2 000 nodes a node row costs the time
# of ~15 chunk calls (PERF.md, the preemption walk's findings), so chunks
# stay small where every key is new.
WALK_CHUNK_KEYS = 4

# Host<->device traffic of the device planner leg: calls and bytes each way
# (every call uploads its tables and fetches its verdict; a class solve's
# preemption pass is one walk call a chunk, the victim tables uploaded once).
PLANNER_TRANSFER = {"gang_calls": 0, "plan_calls": 0, "walk_calls": 0, "h2d_bytes": 0,
                    "d2h_bytes": 0}


def _pending(pods: Sequence[Pod]) -> List[Pod]:
    # the schedulable subset — the same filter every backend applies
    return [p for p in pods if not p.scheduling_gated and not p.bound]


def configure(preemption: bool = True, gang: bool = True) -> None:
    global PRIORITY_ENABLED, GANG_ENABLED
    PRIORITY_ENABLED = bool(preemption)
    GANG_ENABLED = bool(gang)


# ---------------------------------------------------------------------------
# Planner: three bit-identical implementations of the decision math
# ---------------------------------------------------------------------------


def _gang_commit_py(run_placed, run_gang, gang_size, gang_min_ranks):
    """Python-oracle gang verdict: sequential mirror of ffd.gang_commit."""
    ng = len(gang_size)
    placed = [0] * ng
    for c, g in zip(run_placed, run_gang):
        if g >= 0:
            placed[int(g)] += int(c)
    commit = [
        placed[i] >= int(gang_min_ranks[i]) and int(gang_min_ranks[i]) > 0
        for i in range(ng)
    ]
    return (np.asarray(commit, dtype=bool), np.asarray(placed, dtype=np.int32))


def _preemption_plan_py(node_free, victim_prio, victim_req, victim_ok,
                        node_ok, need, pod_prio):
    """Python-oracle preemption plan: sequential mirror of
    ffd.preemption_plan / preemption_plan_host."""
    E, Vm = len(victim_prio), len(victim_prio[0]) if len(victim_prio) else 0
    R = len(need)
    mask = np.zeros((E, Vm), dtype=bool)
    for e in range(E):
        if not node_ok[e]:
            continue
        cum = [int(x) for x in node_free[e]]
        chosen: List[int] = []
        if all(cum[r] >= int(need[r]) for r in range(R)):
            return e, mask  # free capacity alone fits: nothing to evict
        for v in range(Vm):
            if not (victim_ok[e][v] and int(victim_prio[e][v]) < int(pod_prio)):
                continue
            for r in range(R):
                cum[r] += int(victim_req[e][v][r])
            chosen.append(v)
            if all(cum[r] >= int(need[r]) for r in range(R)):
                mask[e, chosen] = True
                return e, mask
    return -1, mask


def gang_commit_host(run_placed, run_gang, gang_size, gang_min_ranks):
    """numpy mirror of ffd.gang_commit: per-gang placed counts by segment
    sum over runs, committed iff placed >= min_ranks (> 0)."""
    ng = int(np.asarray(gang_size).shape[0])
    run_gang = np.asarray(run_gang, dtype=np.int64)
    placed = np.zeros(ng, np.int32)
    hot = run_gang >= 0
    np.add.at(placed, run_gang[hot],
              np.asarray(run_placed, dtype=np.int32)[hot])
    min_ranks = np.asarray(gang_min_ranks, dtype=np.int32)
    commit = (placed >= min_ranks) & (min_ranks > 0)
    return commit, placed


def preemption_plan_host(node_free, victim_prio, victim_req, victim_ok,
                         node_ok, need, pod_prio):
    """numpy mirror of ffd.preemption_plan: first node (ascending) whose
    free capacity plus the minimal eligible-victim prefix (victims arrive
    pre-sorted by ascending (priority, uid)) covers `need`. Returns
    (node_idx, victim_mask [E, Vm] bool)."""
    node_free = np.asarray(node_free, dtype=np.int64)
    victim_prio = np.asarray(victim_prio, dtype=np.int64)
    victim_req = np.asarray(victim_req, dtype=np.int64)
    victim_ok = np.asarray(victim_ok, dtype=bool)
    node_ok = np.asarray(node_ok, dtype=bool)
    need = np.asarray(need, dtype=np.int64)
    E, Vm = victim_prio.shape
    eligible = victim_ok & (victim_prio < int(pod_prio))
    reclaim = np.where(eligible[:, :, None], victim_req, 0)
    cum = node_free[:, None, :] + np.cumsum(reclaim, axis=1)
    fit0 = np.all(node_free >= need[None, :], axis=1)
    fit_at = np.all(cum >= need[None, None, :], axis=2)
    any_fit = node_ok & (fit0 | fit_at.any(axis=1))
    if not any_fit.any():
        return -1, np.zeros((E, Vm), dtype=bool)
    node_idx = int(np.argmax(any_fit))
    take = np.zeros((E, Vm), dtype=bool)
    if not fit0[node_idx]:
        kmin = int(np.argmax(fit_at[node_idx]))
        take[node_idx] = eligible[node_idx] & (np.arange(Vm) <= kmin)
    return node_idx, take


def _on(device, *arrays):
    """Host arrays -> tensors on `device` (None = "cuda"), counted as the
    device leg's upload."""
    import torch

    from .convert import array_to_torch

    dev = torch.device("cuda" if device is None else device)
    PLANNER_TRANSFER["h2d_bytes"] += sum(int(a.nbytes) for a in arrays)
    return [array_to_torch(np.ascontiguousarray(a), dev) for a in arrays]


def _fetch(*tensors):
    out = [t.cpu().numpy() for t in tensors]
    PLANNER_TRANSFER["d2h_bytes"] += sum(int(a.nbytes) for a in out)
    return out


def _gang_commit_device(run_placed, run_gang, gang_size, gang_min_ranks, device=None):
    """The device leg of the gang verdict: cuda/ffd.py gang_commit on
    `device` (K10 on the card, its plain version on the CPU)."""
    from .cuda import ffd

    PLANNER_TRANSFER["gang_calls"] += 1
    args = _on(device, np.asarray(run_placed, np.int32), np.asarray(run_gang, np.int32),
               np.asarray(gang_size, np.int32), np.asarray(gang_min_ranks, np.int32))
    commit, placed = _fetch(*ffd.gang_commit(*args))
    return commit, placed


def _preemption_plan_device(node_free, victim_prio, victim_req, victim_ok,
                            node_ok, need, pod_prio, device=None):
    """The device leg of one preemption plan: cuda/ffd.py preemption_plan
    on `device` (K11 on the card, its plain version on the CPU). Returns
    (node index, numpy [E, Vm] bool mask)."""
    from .cuda import ffd

    PLANNER_TRANSFER["plan_calls"] += 1
    args = _on(device, np.asarray(node_free, np.int32), np.asarray(victim_prio, np.int32),
               np.asarray(victim_req, np.int32), np.asarray(victim_ok, bool),
               np.asarray(node_ok, bool), np.asarray(need, np.int32))
    node_idx, take = _fetch(*ffd.preemption_plan(*args, int(pod_prio)))
    return int(node_idx), take


def _preemption_walk_device(tables, masks, cand_row, need, prio, budget, device=None):
    """The device leg's preemption walk over one chunk of candidates:
    cuda/ffd.py preemption_walk on `device` (the walk kernel on the card,
    its plain version on the CPU). `tables` (node_free, victim_prio,
    victim_req, victim_ok) are host arrays on a pass's first chunk, uploaded
    here, and the previous chunk's card tensors after it; the chunk's node
    rows, need and priority go up, its wire comes back. Returns (rows
    [(candidate, node, victim)] in the loop's order, budget flag, the tables
    for the next chunk)."""
    from .cuda import ffd

    PLANNER_TRANSFER["walk_calls"] += 1
    node_free, victim_prio, victim_req, victim_ok = tables
    if isinstance(node_free, np.ndarray):
        node_free, victim_prio, victim_req, victim_ok = _on(
            device, np.asarray(node_free, np.int32), np.asarray(victim_prio, np.int32),
            np.asarray(victim_req, np.int32), np.asarray(victim_ok, bool))
    chunk = _on(device, np.asarray(masks, bool), np.asarray(cand_row, np.int32),
                np.asarray(need, np.int32), np.asarray(prio, np.int32))
    out = ffd.preemption_walk(node_free, victim_prio, victim_req, victim_ok, *chunk, int(budget))
    (wire,) = _fetch(out.wire)
    rows, flag = ffd.unpack_walk(wire)
    return rows, flag, (out.node_free, victim_prio, victim_req, out.victim_ok)


def _walk_host(plan_fn, tables, masks, cand_row, need, prio, budget):
    """The oracle and host legs' preemption walk over one chunk: the
    reference's loop, one `plan_fn` call a candidate, on copies of
    node_free and victim_ok (the walk's contract: cuda/ffd.py
    preemption_walk_plain). Returns (rows [(candidate, node, victim)],
    budget flag, the tables for the next chunk)."""
    node_free, victim_prio, victim_req, victim_ok = tables
    node_free, victim_ok = np.array(node_free), np.array(victim_ok)
    rows: List[Tuple[int, int, int]] = []
    flag = False
    for c in range(len(cand_row)):
        if len(rows) >= budget:
            flag = True
            break
        node_ok = masks[cand_row[c]]
        if not node_ok.any():
            continue
        e, take = plan_fn(node_free, victim_prio, victim_req, victim_ok, node_ok, need[c],
                          int(prio[c]))
        if e < 0:
            continue
        hot = np.flatnonzero(np.asarray(take)[e])
        if not len(hot):
            continue  # free capacity fit — nothing to evict
        for v in hot:
            rows.append((c, int(e), int(v)))
            node_free[e] += victim_req[e, int(v)]
            victim_ok[e, int(v)] = False
        # the freed capacity is spoken for: the pending pod lands there
        # next reconcile, so later candidates see the remainder
        node_free[e] = np.maximum(node_free[e] - need[c].astype(np.int64), 0)
    return rows, flag, (node_free, victim_prio, victim_req, victim_ok)


def walk_in_chunks(walk_fn, tables, chunk_at, C: int, budget: int):
    """The preemption pass over C candidates, a chunk at a time:
    chunk_at(lo) gives the tables (masks, cand_row, need, prio) of the chunk
    that starts at candidate lo, and walk_fn (a WALKS leg) walks it under
    the budget left, carrying `tables` (node_free, victim_prio, victim_req,
    victim_ok) on. The same as one walk over every candidate: a chunk's
    budget flag is the pass's, and a pass whose count reaches the budget
    between chunks stops there with the flag set. Returns (rows
    [(candidate, node, victim)], budget flag, the final tables)."""
    rows: List[Tuple[int, int, int]] = []
    lo = 0
    while lo < C:
        if len(rows) >= budget:
            return rows, True, tables
        masks, cand_row, need, prio = chunk_at(lo)
        got, flag, tables = walk_fn(tables, masks, cand_row, need, prio, budget - len(rows))
        rows += [(lo + c, e, v) for c, e, v in got]
        if flag:
            return rows, True, tables
        lo += len(cand_row)
    return rows, False, tables


# Each leg's gang verdict and single preemption plan (the reference's
# PLANNERS), and its preemption walk: the oracle and host legs walk one plan
# call a candidate, the device leg one walk call a chunk.
PLANNERS = {
    "oracle": (_gang_commit_py, _preemption_plan_py),
    "host": (gang_commit_host, preemption_plan_host),
    "device": (_gang_commit_device, _preemption_plan_device),
}
WALKS = {
    "oracle": functools.partial(_walk_host, _preemption_plan_py),
    "host": functools.partial(_walk_host, preemption_plan_host),
    "device": _preemption_walk_device,
}


def select_planner(solver) -> str:
    """Planner leg for a wrapper chain: the concrete backend at the bottom
    picks it (the device leg for TorchSolver, the python oracle otherwise).
    All three are bit-identical — this only decides WHERE the math runs."""
    from .backend import concrete_backend

    if type(concrete_backend(solver)).__name__ == "TorchSolver":
        return "device"
    return "oracle"


# ---------------------------------------------------------------------------
# Victim tensors (shared input tables — one order for every planner)
# ---------------------------------------------------------------------------


def build_victim_tensors(nodes, rkeys: Sequence[str]):
    """Per-node victim tables for the preemption planner, victims sorted
    ascending (priority, uid) — THE order all three implementations walk.
    Returns (node_free [E,R] i32, victim_prio [E,Vm] i32, victim_req
    [E,Vm,R] i32, victim_ok [E,Vm] bool, victim_uids [E][Vm]). Quantization
    matches encode: free and reclaim floor (conservative), padding rows are
    ineligible (ok=False, prio=INT32_MAX)."""
    from .encode import _quantize

    E = len(nodes)
    R = len(rkeys)
    vm = max([len(n.bound_pods) for n in nodes] + [1])
    node_free = np.zeros((E, R), np.int32)
    victim_prio = np.full((E, vm), INT32_MAX, np.int32)
    victim_req = np.zeros((E, vm, R), np.int32)
    victim_ok = np.zeros((E, vm), bool)
    victim_uids: List[List[Optional[str]]] = [[None] * vm for _ in range(E)]
    for e, n in enumerate(nodes):
        node_free[e] = _quantize(n.free, list(rkeys), ceil=False)
        victims = sorted(n.bound_pods, key=lambda b: (b.priority, b.uid))
        for v, b in enumerate(victims):
            victim_prio[e, v] = min(b.priority, INT32_MAX)
            req = _quantize(b.requests, list(rkeys), ceil=False)
            if PODS in rkeys:
                req[list(rkeys).index(PODS)] = 1
            victim_req[e, v] = req
            victim_ok[e, v] = bool(b.evictable)
            victim_uids[e][v] = b.uid
    return node_free, victim_prio, victim_req, victim_ok, victim_uids


def node_ok_mask(p: Pod, nodes) -> np.ndarray:
    """[E] bool: the existing nodes pending pod `p` may land on once
    capacity frees (schedulable, tolerated taints, strictly compatible
    labels)."""
    preqs = p.scheduling_requirements()
    return np.fromiter(
        (
            n.schedulable
            and tolerates_all(p.tolerations, n.taints)
            and preqs.strictly_compatible(Requirements.from_labels(n.labels))
            for n in nodes
        ),
        bool, len(nodes),
    )


def mask_key(p: Pod) -> tuple:
    """What node_ok_mask reads of `p`, hashable: the fields its
    scheduling_requirements() folds (node selector, required node-affinity
    terms, bound volume zones) and its tolerations as a set. Pods with equal
    keys get equal rows; the key is finer than the rows where two term lists
    fold to the same requirements."""
    zones = None if p.volume_zones is None else tuple(p.volume_zones)
    return (frozenset(p.node_selector.items()),
            tuple(frozenset(t.items()) for t in p.node_affinity), zones,
            frozenset(p.tolerations))


def node_ok_table(pods: Sequence[Pod], nodes, cache: Optional[Dict[tuple, np.ndarray]] = None,
                  max_new: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The pods' node_ok_mask rows, one per distinct mask_key: (masks [U, E]
    bool, row [n] int32 — pod i's mask is masks[row[i]]). n is len(pods),
    or with `max_new` the longest prefix of `pods` that holds at most
    max_new keys not in `cache`. `cache` (mask_key -> row), filled here,
    carries the rows from one call to the next."""
    cache = {} if cache is None else cache
    index: Dict[tuple, int] = {}
    masks: List[np.ndarray] = []
    row: List[int] = []
    new = 0
    for p in pods:
        k = mask_key(p)
        r = index.get(k)
        if r is None:
            m = cache.get(k)
            if m is None:
                if new == max_new:
                    break
                new += 1
                m = cache[k] = node_ok_mask(p, nodes)
            r = index[k] = len(masks)
            masks.append(m)
        row.append(r)
    table = np.stack(masks) if masks else np.zeros((0, len(nodes)), bool)
    return table, np.asarray(row, np.int32)


# ---------------------------------------------------------------------------
# The class-aware solve seam
# ---------------------------------------------------------------------------


class _Deferred:
    """Minimal async-seam adapter: `.result()` runs the deferred solve. A
    class-engaged solve is a multi-dispatch composite, so it runs whole when
    its result is asked for."""

    def __init__(self, fn):
        self._fn = fn

    def result(self):
        return self._fn()


class ClassAwareSolver:
    """Wraps any solver with priority/preemption/gang semantics. Inert —
    verbatim delegation, including the inner async seam — whenever the
    batch is priority-flat and gang-free or the knobs are off."""

    def __init__(self, inner, planner: str = "auto"):
        self.inner = inner
        self._planner_choice = planner
        # NOT named `stats`: wrapper attribute lookup must keep delegating
        # the concrete backend's stats dict through the chain
        self.class_stats: Dict[str, int] = {
            "class_solves": 0,
            "gang_rounds": 0,
            "gangs_placed": 0,
            "gangs_unschedulable": 0,
            "preemptions": 0,
            "priority_inversions": 0,
            "declines": 0,
        }

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- engagement ----------------------------------------------------------

    def _gangs(self, pods: Sequence[Pod]) -> Dict[str, Tuple[int, int, List[str]]]:
        out: Dict[str, Tuple[int, int, List[str]]] = {}
        for p in _pending(pods):
            g = p.gang()
            if g is None:
                continue
            gid, size, min_ranks = g
            prev = out.get(gid)
            if prev is None:
                out[gid] = (size, min_ranks, [p.meta.uid])
            else:
                out[gid] = (
                    max(prev[0], size), max(prev[1], min_ranks),
                    prev[2] + [p.meta.uid],
                )
        return out

    def _engaged(self, inp: SolverInput) -> bool:
        pending = _pending(inp.pods)
        if GANG_ENABLED and any(p.gang() for p in pending):
            return True
        if not PRIORITY_ENABLED or not pending:
            return False
        top = max(p.priority for p in pending)
        return any(
            b.priority < top and b.evictable
            for n in inp.nodes for b in n.bound_pods
        )

    # -- the solver surface --------------------------------------------------

    def solve(self, inp: SolverInput) -> SolverResult:
        if not self._engaged(inp):
            return self.inner.solve(inp)
        return self._solve_class(inp)

    def solve_async(self, inp: SolverInput):
        if not self._engaged(inp):
            sa = getattr(self.inner, "solve_async", None)
            if sa is not None:
                return sa(inp)
            return _Deferred(lambda: self.inner.solve(inp))
        return _Deferred(lambda: self._solve_class(inp))

    def solve_cohort_async(self, inps):
        """Cohort seam: engaged members (gang/priority semantics) run the
        class path, since their solve is a multi-round plan and cannot fuse,
        while the flat remainder rides the inner backend's fused cohort
        entry point. Outcome list order matches `inps`."""
        n = len(inps)
        inner_sc = getattr(self.inner, "solve_cohort_async", None)
        engaged = [i for i in range(n) if self._engaged(inps[i])]
        handles: dict = {}
        for i in engaged:
            try:
                handles[i] = self.solve_async(inps[i])
            except Exception as e:  # noqa: BLE001 — per-member outcome
                handles[i] = e
        flat = [i for i in range(n) if i not in handles]
        flat_fin = None
        if flat and inner_sc is not None:
            flat_fin = inner_sc([inps[i] for i in flat])
        elif flat:
            for i in flat:
                try:
                    handles[i] = self.solve_async(inps[i])
                except Exception as e:  # noqa: BLE001 — per-member outcome
                    handles[i] = e

        def finish():
            results: list = [None] * n
            if flat_fin is not None:
                for i, oc in zip(flat, flat_fin()):
                    results[i] = oc
            for i, h in handles.items():
                if isinstance(h, BaseException):
                    results[i] = h
                    continue
                try:
                    results[i] = h.result()
                except Exception as e:  # noqa: BLE001 — per-member outcome
                    results[i] = e
            return results

        return finish

    # -- class passes --------------------------------------------------------

    def _decline(self, reason: str) -> None:
        self.class_stats["declines"] += 1

    def _planners(self):
        """(gang_fn, walk_fn) of the chosen leg; the device leg runs on the
        concrete backend's device."""
        planner = self._planner_choice
        if planner == "auto":
            planner = select_planner(self.inner)
        gang_fn, walk_fn = PLANNERS[planner][0], WALKS[planner]
        if planner == "device":
            from .backend import concrete_backend

            dev = getattr(concrete_backend(self.inner), "device", None)
            gang_fn = functools.partial(gang_fn, device=dev)
            walk_fn = functools.partial(walk_fn, device=dev)
        return gang_fn, walk_fn

    def _solve_class(self, inp: SolverInput) -> SolverResult:
        self.class_stats["class_solves"] += 1
        gang_fn, walk_fn = self._planners()

        pods = list(inp.pods)
        if GANG_ENABLED:
            pods = _inject_gang_affinity(pods)
        work = dataclasses.replace(inp, pods=pods) if pods is not inp.pods else inp

        res = self.inner.solve(work)
        gangs_unschedulable: List[str] = []

        # ---- atomic gang pass ---------------------------------------------
        if GANG_ENABLED:
            gangs = self._gangs(pods)
            # oversized gangs can never commit within one claim budget:
            # declined up front, stripped without a verdict round
            for gid, (size, _mr, members) in sorted(gangs.items()):
                if size > GANG_CLAIM_BUDGET:
                    self._decline("gang_claim_budget")
                    gangs_unschedulable.append(gid)
            if gangs_unschedulable:
                # all-or-nothing holds for declined gangs too: strip their
                # members and re-solve, or the base solve's partial
                # placements would leak through the decline
                pods = [
                    p for p in pods
                    if (p.gang() or ("",))[0] not in gangs_unschedulable
                ]
                work = dataclasses.replace(work, pods=pods)
                res = self.inner.solve(work)
            rounds = 0
            while gangs and rounds <= len(gangs):
                rounds += 1
                failing = self._first_failing_gang(
                    pods, res, gangs, gangs_unschedulable, gang_fn
                )
                if failing is None:
                    break
                gangs_unschedulable.append(failing)
                # rollback == strip + re-solve: decisions before the gang's
                # first run are order-stable
                pods = [
                    p for p in pods
                    if (p.gang() or ("",))[0] != failing
                ]
                work = dataclasses.replace(work, pods=pods)
                res = self.inner.solve(work)
                self.class_stats["gang_rounds"] += 1
            committed = [g for g in gangs if g not in gangs_unschedulable]
            self.class_stats["gangs_placed"] += len(committed)
            self.class_stats["gangs_unschedulable"] += len(gangs_unschedulable)
            # provenance: per-gang verdicts are decision facts the result
            # object doesn't carry (beyond the unschedulable list) — staged
            # for the class-level explain capture below
            for gid, (_size, mr, members) in sorted(gangs.items()):
                obsexplain.note("gang", {
                    "gang": gid,
                    "committed": gid not in gangs_unschedulable,
                    "placed": sum(1 for u in members if u in res.placements),
                    "min_ranks": mr,
                })

        # ---- preemption pass ----------------------------------------------
        evictions: List[Eviction] = []
        if PRIORITY_ENABLED:
            evictions = self._plan_preemptions(inp, pods, res, walk_fn)

        # ---- surface ------------------------------------------------------
        errors = dict(res.errors)
        for gid in gangs_unschedulable:
            for p in inp.pods:
                g = p.gang()
                if g is not None and g[0] == gid:
                    errors[p.meta.uid] = (
                        f"gang {gid} unschedulable: fewer than min-ranks "
                        "members could place (all-or-nothing rollback)"
                    )
        inversions = _count_inversions(inp, res)
        if inversions:
            self.class_stats["priority_inversions"] += inversions
        final = dataclasses.replace(
            res,
            errors=errors,
            evictions=evictions,
            gangs_unschedulable=sorted(set(gangs_unschedulable)),
        )
        if obsexplain.enabled():
            # the class-level record re-derives over the FINAL result (post
            # strip/re-solve, with evictions + gang verdicts attached)
            obsexplain.capture(inp, final, "class", drain_notes=True)
        return final

    def _first_failing_gang(self, pods, res, gangs, already, gang_fn):
        """First gang in scan order whose verdict fails, via the planner's
        gang_commit over the per-pod run decomposition (runs of length one
        of the class-sorted pod list — a valid run split, so the segment-sum
        kernel consumes it unchanged)."""
        live = {g: v for g, v in gangs.items() if g not in already}
        if not live:
            return None
        gang_ids = sorted(live)
        rank = {g: i for i, g in enumerate(gang_ids)}
        spods = ffd_sort(_pending(pods))
        run_placed = [1 if p.meta.uid in res.placements else 0 for p in spods]
        run_gang = [
            rank.get((p.gang() or ("",))[0], -1) for p in spods
        ]
        gang_size = [live[g][0] for g in gang_ids]
        gang_min_ranks = [live[g][1] for g in gang_ids]
        commit, _placed = gang_fn(run_placed, run_gang, gang_size, gang_min_ranks)
        # scan order of gangs = first appearance in the sorted pod list
        for p in spods:
            g = p.gang()
            if g is None or g[0] not in rank:
                continue
            if not bool(commit[rank[g[0]]]):
                return g[0]
        return None

    def _plan_preemptions(self, inp, pods, res, walk_fn) -> List[Eviction]:
        candidates = [
            p for p in ffd_sort(_pending(pods))
            if p.meta.uid not in res.placements
        ]
        if not candidates or not inp.nodes:
            return []
        if not any(b.evictable for n in inp.nodes for b in n.bound_pods):
            return []
        # V/Q interaction: an eviction changes domain member counts the
        # engines already consumed — inexpressible mid-plan, decline whole
        if any(p.topology_spread or p.affinity_terms for p in pods):
            self._decline("preemption_topology")
            return []
        rkeys = sorted(
            {k for p in candidates for k in p.requests}
            | {k for n in inp.nodes for b in n.bound_pods for k in b.requests}
            | {"cpu", "memory", PODS}
        )
        node_free, victim_prio, victim_req, victim_ok, victim_uids = (
            build_victim_tensors(inp.nodes, rkeys)
        )
        from .encode import _quantize

        pods_col = rkeys.index(PODS)
        # the free tables reflect PRE-solve state: charge this solve's own
        # existing-node placements before planning, or the planner re-offers
        # capacity the committed placements already consumed
        node_rank = {n.id: e for e, n in enumerate(inp.nodes)}
        by_uid = {p.meta.uid: p for p in pods}
        for uid, placement in res.placements.items():
            if placement[0] != "node" or uid not in by_uid:
                continue
            e = node_rank.get(placement[1])
            if e is None:
                continue
            used = _quantize(by_uid[uid].requests, rkeys, ceil=True)
            used[pods_col] = max(used[pods_col], 1)
            node_free[e] = np.maximum(node_free[e] - used, 0)
        # the walk in class-FFD order, a chunk of candidates at a time: node
        # rows one per distinct mask_key, built as the chunks reach them
        cache: Dict[tuple, np.ndarray] = {}

        def chunk_at(lo):
            masks, cand_row = node_ok_table(candidates[lo:], inp.nodes, cache, WALK_CHUNK_KEYS)
            chunk = candidates[lo:lo + len(cand_row)]
            need = np.asarray([_quantize(p.requests, rkeys, ceil=True) for p in chunk],
                              np.int32).reshape(len(chunk), len(rkeys))
            need[:, pods_col] = np.maximum(need[:, pods_col], 1)
            return masks, cand_row, need, np.asarray([p.priority for p in chunk], np.int64)

        rows, over_budget, _ = walk_in_chunks(
            walk_fn, (node_free, victim_prio, victim_req, victim_ok), chunk_at, len(candidates),
            MAX_EVICTIONS_PER_SOLVE,
        )
        if over_budget:
            self._decline("eviction_budget")
        evictions = [
            Eviction(
                node_id=inp.nodes[e].id,
                pod_uid=victim_uids[e][v],
                victim_priority=int(victim_prio[e, v]),
                for_pod=candidates[c].meta.uid,
            )
            for c, e, v in rows
        ]
        if evictions:
            # the wire format is the contract even on the host path: rows
            # that cannot pack (uint16 overflow) decline
            packed = _pack_rows(inp, evictions)
            if packed is None:
                self._decline("evict_overflow")
                evictions = []
            else:
                self.class_stats["preemptions"] += len(evictions)
        return evictions


def _pack_rows(inp, evictions) -> Optional[List[Eviction]]:
    """Round-trip the planned evictions through the uint16 eviction table
    (cuda/ffd.py pack_evictions wire format). Returns the decoded rows —
    identical by construction — or None on overflow (caller declines)."""
    from .cuda import ffd

    node_rank = {n.id: e for e, n in enumerate(inp.nodes)}
    uid_rank: Dict[str, int] = {}
    entries = []
    for ev in evictions:
        uid_rank.setdefault(ev.pod_uid, len(uid_rank))
        entries.append((node_rank[ev.node_id], uid_rank[ev.pod_uid]))
    buf = ffd.pack_evictions(entries)
    overflow, rows = ffd.unpack_evictions(buf)
    if overflow:
        return None
    assert rows == entries
    return evictions


def _inject_gang_affinity(pods: List[Pod]) -> List[Pod]:
    """Rank-aware co-location: members of a gang labeled with
    GANG_TOPOLOGY_LABEL gain a PREFERRED self-affinity on that topology key
    — the ordinary relax ladder satisfies it when capacity allows and drops
    it (by weight) when it cannot, identically on every backend. Returns
    the input list unchanged (same object) when nothing injects."""
    out: List[Pod] = []
    changed = False
    for p in pods:
        g = p.gang()
        key = p.meta.labels.get(wk.GANG_TOPOLOGY_LABEL)
        if g is None or key not in wk.TOPOLOGY_KEYS:
            out.append(p)
            continue
        term = PodAffinityTerm(
            label_selector={wk.GANG_LABEL: g[0]},
            topology_key=key,
            weight=1,
        )
        out.append(dataclasses.replace(
            p, affinity_terms=[*p.affinity_terms, term]
        ))
        changed = True
    return out if changed else pods


def _count_inversions(inp: SolverInput, res: SolverResult,
                      cap_unplaced: int = 64, cap_placed: int = 512) -> int:
    """Priority inversions in a finished solve: an unplaced pod p and a
    strictly-lower-priority pod q placed on an existing node that admits p
    with a committed slot big enough for p. Priority-major scan order makes
    this structurally impossible, so the count stays 0; it exists to catch
    an ordering regression."""
    pending = _pending(inp.pods)
    unplaced = [p for p in pending if p.meta.uid in res.errors][:cap_unplaced]
    if not unplaced:
        return 0
    by_uid = {p.meta.uid: p for p in pending}
    nodes = {n.id: n for n in inp.nodes}
    placed: List[Tuple[Pod, object]] = []
    for uid, (kind, target) in res.placements.items():
        if kind == "node" and uid in by_uid and target in nodes:
            placed.append((by_uid[uid], nodes[target]))
            if len(placed) >= cap_placed:
                break
    count = 0
    for p in unplaced:
        preqs = p.scheduling_requirements()
        for q, n in placed:
            if q.priority >= p.priority:
                continue
            if not tolerates_all(p.tolerations, n.taints):
                continue
            if not preqs.strictly_compatible(Requirements.from_labels(n.labels)):
                continue
            if all(
                q.requests.get_(k) >= p.requests.get_(k) for k in p.requests
            ):
                count += 1
                break
    return count
