# Port copy of karpenter_tpu/solver/convex.py (the metric counters and the
# flight dumps are counted in ConvexSolver.convex_stats; trace spans left
# out). _build_consolidate is vectorised with numpy broadcasts; its arrays
# equal the reference's field by field.
"""Global-optimal solver backend: the projected-ADMM packer on the GPU.

The second backend behind the `Solver` seam. Where the FFD kernel commits
pods one run at a time in a greedy scan, this backend relaxes the whole
placement to a dense fractional assignment tensor `X[pod_runs x
candidate_columns]` and descends a penalized objective — price-weighted
node-open cost plus a quadratic capacity-violation penalty — with every
iterate projected back onto the per-run feasibility simplex (masked rows
from the SAME `EncodedInput` tables the FFD kernel consumes; no second
encode path).

Three layers:

- `admm_pack` (solver/cuda/convex.py, K13) — the device program: max_iters
  iterations of load -> overload penalty gradient -> cost gradient ->
  masked row-simplex projection, the convergence latch carried beside X and
  fetched with it in one message. The problem tensors adopt into the inner
  backend's `ArgumentArena` under the `("convex",)` residency namespace
  (K8 unpacks them), and the dispatch is eager behind `solve_async`.

- `ConvexSolver` — the `Solver` wrapper. Engages only when every NodePool
  in the input resolves to the convex backend (per-pool
  `karpenter.sh/solver-backend` label, else the operator default) AND the
  input is inside the device-expressible scope the FFD kernel itself
  dispatches (no preference relaxation, no fallback-flagged groups, no
  topology/affinity carve-outs). Everything else delegates VERBATIM to the
  inner solver. Non-convergence, invariant-gate rejection, or min-values
  failure falls back LOUDLY to the inner FFD solver: counted in
  `convex_stats`. Unlike the reference, no `try` wraps the dispatch, the
  fetch or the arena adopt: a K13 or K8 that fails to build or launch
  raises out of the solve instead of falling back.

- `consolidate_global` — the one-shot whole-cluster consolidation entry.
  One batched program over rows = (run x owning candidate) with columns =
  surviving nodes plus a priced "stay" column per candidate proposes the
  candidate SUBSET whose pods re-place onto the surviving fleet. The caller
  verifies the proposal with one sequential simulate.

Rounding determinism: pods round in solver (run) order; each pod walks its
candidate columns by descending fractional mass, ties broken by (existing
node before new claim, then column price, then column index); claims fill
first-fit in creation order under the exact integer capacity,
pairwise-compatibility, offering, and pool-limit rules the FFD kernel
enforces. The result is assembled by the SAME `_decode_from_codes` tail the
device decode uses.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import explain as obsexplain
from .backend import (
    AsyncSolve,
    Solver,
    _decode_from_codes,
    concrete_backend,
    min_values_post_check,
)
from .cuda.convex import admm_pack
from .encode import EncodedInput, encode, quantize_input
from .resilient import check_invariants

# positional tensor arguments of admm_pack, in order; `tol` rides as a
# scalar beside them
CONVEX_ARG_SPEC = ("run_req", "run_count", "cand_cap", "cand_cost", "feas", "tol")
CONVEX_STATICS = ("max_iters",)

# a deleted candidate must shed essentially ALL fractional mass from its
# priced stay column before consolidate_global proposes it
_STAY_EPS = 0.2

# penalty weight on capacity violations (the ADMM-style augmented term)
_RHO = 8.0
# entropic step size and its annealing horizon (eta grows linearly with the
# iteration index, capped at _ETA_MAX), and the damping step's geometric
# decay horizon (beta = 0.5 * 2^(-i / _TAU)): the reference's tuning
_ETA0 = 3.0
_ANNEAL = 10.0
_ETA_MAX = 18.0
_TAU = 40.0

# the small bucket lattice prewarm_aot builds and launches
PREWARM_BUCKETS = ((16, 16), (32, 32), (64, 64))


def _bucket(n: int, mult: int, floor: int) -> int:
    return max(floor, ((n + mult - 1) // mult) * mult)


# ---------------------------------------------------------------------------
# problem builders (EncodedInput tables -> dense column model)
# ---------------------------------------------------------------------------


@dataclass
class _Problem:
    """One ADMM problem instance: S rows (pod runs) x N columns."""

    E: int  # node columns occupy [0, E); macro/stay columns follow
    req: np.ndarray  # [S, R] float32
    count: np.ndarray  # [S] int32
    feas: np.ndarray  # [S, N] bool
    cap: np.ndarray  # [N, R] float32
    cost: np.ndarray  # [N] float32
    price: np.ndarray  # [N] float64 rounding tie-break (0 for node columns)
    macro_pt: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    alloc: Dict[int, np.ndarray] = field(default_factory=dict)  # col -> type_alloc[t]
    charge: Dict[int, np.ndarray] = field(default_factory=dict)  # pool-limit charge
    adm: Dict[int, np.ndarray] = field(default_factory=dict)  # col -> [Z, C] offering
    stay_owner: Dict[int, int] = field(default_factory=dict)  # consolidation only
    rows_owner: Optional[np.ndarray] = None  # [S] candidate owning each row


def pad_problem(prob) -> tuple:
    """The problem's admm_pack arguments (CONVEX_ARG_SPEC without tol) as
    numpy, padded to the shape buckets (multiples of 16, at least 16) with
    zero rows and columns that are nowhere feasible."""
    S, N = prob.feas.shape
    R = prob.cap.shape[1]
    Sp, Np = _bucket(S, 16, 16), _bucket(N, 16, 16)
    run_req = np.zeros((Sp, R), dtype=np.float32)
    run_req[:S] = prob.req
    run_count = np.zeros(Sp, dtype=np.int32)
    run_count[:S] = prob.count
    cap = np.zeros((Np, R), dtype=np.float32)
    cap[:N] = prob.cap
    cost = np.zeros(Np, dtype=np.float32)
    cost[:N] = prob.cost
    feas = np.zeros((Sp, Np), dtype=bool)
    feas[:S, :N] = prob.feas
    return run_req, run_count, cap, cost, feas


def _build_provision(enc: EncodedInput, max_macros: int) -> Optional[_Problem]:
    """Provisioning columns: every existing node plus one "macro" column
    per admissible (pool, instance-type) pair — a macro stands for as many
    claims of that shape as rounding needs, priced at the cheapest
    admissible offering. Wide catalogs truncate to the cheapest
    `max_macros` macros with a per-group feasibility rescue (a group whose
    every feasible macro was cut gets its cheapest one re-added), so the
    dense relaxation stays bounded without losing placeability. Returns
    None only when there are no columns at all (caller counts a decline)."""
    S = len(enc.run_group)
    E = len(enc.node_ids)
    G, R = enc.group_req.shape
    P, T = enc.pool_type.shape
    run_g = enc.run_group.astype(int)
    greq = enc.group_req.astype(np.int64)
    demand_tot = (greq[run_g] * enc.run_count.astype(np.int64)[:, None]).sum(axis=0)

    # existing-node feasibility: admission mask x single-pod fit
    if E:
        nfit = (enc.node_free.astype(np.int64)[None, :, :] >= greq[run_g][:, None, :]).all(
            axis=2
        )
        feas_nodes = enc.node_compat[run_g] & nfit  # [S, E]
    else:
        feas_nodes = np.zeros((S, 0), dtype=bool)

    # group x (zone x ct) joint admissibility, reused per macro column
    gzc = enc.group_zone[:, :, None] & enc.group_ct[:, None, :]  # [G, Z, C]

    macros = []  # (price, p, t, adm, usable, charge, ok_g)
    for p in range(P):
        padm = np.outer(enc.pool_zone[p], enc.pool_ct[p])  # [Z, C]
        daemon = enc.pool_daemon[p].astype(np.int64)
        for t in np.flatnonzero(enc.pool_type[p]):
            t = int(t)
            adm = enc.offer_avail[t] & padm
            if not adm.any():
                continue
            price = float(enc.offer_price[t][adm].min())
            if not np.isfinite(price):
                continue
            usable = enc.type_alloc[t].astype(np.int64) - daemon
            if (usable <= 0).all():
                continue
            charge = np.where(enc.charge_axes, enc.type_capacity[t], 0).astype(np.int64)
            # feasibility: pool + type compat, fit under the daemon
            # overhead, and a jointly admissible offering for the group's
            # zone/ct sets
            ok_g = (
                enc.group_pool[:, p]
                & enc.group_compat_t[:, t]
                & (usable[None, :] >= greq).all(axis=1)
                & (gzc & adm[None]).any(axis=(1, 2))
            )
            if not ok_g.any():
                continue
            macros.append((price, p, t, adm, usable, charge, ok_g))
    macros.sort(key=lambda m: (m[0], m[1], m[2]))
    if len(macros) > max_macros:
        kept = macros[:max_macros]
        covered = np.zeros(G, dtype=bool)
        for m in kept:
            covered |= m[6]
        for m in macros[max_macros:]:  # price order: cheapest rescue wins
            if (m[6] & ~covered).any():
                kept.append(m)
                covered |= m[6]
        macros = kept
    N = E + len(macros)
    if N == 0:
        return None

    feas = np.zeros((S, N), dtype=bool)
    feas[:, :E] = feas_nodes
    cap = np.zeros((N, R), dtype=np.float32)
    cost = np.zeros(N, dtype=np.float32)
    price_col = np.zeros(N, dtype=np.float64)
    if E:
        cap[:E] = enc.node_free.astype(np.float32)
    prob = _Problem(
        E=E,
        req=greq[run_g].astype(np.float32),
        count=enc.run_count.astype(np.int32),
        feas=feas,
        cap=cap,
        cost=cost,
        price=price_col,
    )
    ref = np.maximum(
        np.max(np.concatenate([cap[:E], np.stack([m[4] for m in macros])])
               if macros else cap[:E], axis=0),
        1.0,
    ) if N else np.ones(R)
    # per-node open surcharge amortized over the shape's capacity: kappa /
    # unorm shrinks with instance size, so at comparable per-unit prices
    # the relaxation prefers FEWER, LARGER nodes
    kappa = 0.25 * max(m[0] for m in macros) if macros else 0.0
    for i, (price, p, t, adm, usable, charge, ok_g) in enumerate(macros):
        n = E + i
        prob.macro_pt[n] = (p, t)
        prob.alloc[n] = enc.type_alloc[t].astype(np.int64)
        prob.charge[n] = charge
        prob.adm[n] = adm
        price_col[n] = price
        # open cost per unit of normalized demand: cheaper-per-capacity
        # shapes win the fractional mass
        unorm = float(np.sum(np.maximum(usable, 0) / ref))
        cost[n] = np.float32((price + kappa) / max(unorm, 1e-6))
        # macro budget: enough claim-slots of this shape to hold the whole
        # batch (bounded), so capacity pressure lands on EXISTING nodes
        with np.errstate(divide="ignore"):
            need = demand_tot / np.maximum(usable, 1)
        n_need = int(np.clip(np.ceil(need[demand_tot > 0].max() if (demand_tot > 0).any() else 1), 1, 64))
        cap[n] = (np.maximum(usable, 0) * n_need).astype(np.float32)
        feas[:, n] = ok_g[run_g]
    return prob


def _build_consolidate(
    enc: EncodedInput,
    owners: List[Tuple[int, int, int]],  # (group, count, candidate) per row
    target_nodes: List[int],  # surviving (non-candidate) node indices
    prices: Sequence[float],
) -> _Problem:
    """Consolidation columns: the surviving fleet's nodes (sunk, cost 0)
    plus one priced "stay" column per candidate — mass left on a stay
    column is load that could NOT re-place, so candidates whose rows shed
    their stay mass are the deletable subset. The node block of the mask is
    computed once per distinct row group (admission x single-pod fit over
    the surviving nodes) and gathered to the rows."""
    R = enc.group_req.shape[1]
    S = len(owners)
    J = len(prices)
    Nn = len(target_nodes)
    N = Nn + J
    greq = enc.group_req.astype(np.int64)
    own = np.asarray(owners, dtype=np.int64).reshape(S, 3)
    row_g = own[:, 0]
    req = greq[row_g].astype(np.float32)
    count = own[:, 1].astype(np.int32)
    rows_owner = own[:, 2].copy()
    tn = np.asarray(target_nodes, dtype=np.int64)
    free_t = enc.node_free.astype(np.int64)[tn]  # [Nn, R]
    gs, g_of_row = np.unique(row_g, return_inverse=True)
    fit_g = enc.node_compat[gs][:, tn].astype(bool) & (
        free_t[None, :, :] >= greq[gs][:, None, :]
    ).all(axis=2)  # [Gs, Nn]
    feas = np.zeros((S, N), dtype=bool)
    feas[:, :Nn] = fit_g[g_of_row.reshape(-1)]
    feas[np.arange(S), Nn + rows_owner] = True  # staying put is always admissible
    cap = np.zeros((N, R), dtype=np.float32)
    cap[:Nn] = free_t.astype(np.float32)
    demand_tot = (req * count[:, None].astype(np.float32)).sum(axis=0)
    cap[Nn:] = np.maximum(demand_tot, 1.0)[None, :]  # stay columns never bind
    cost = np.zeros(N, dtype=np.float32)
    price_col = np.zeros(N, dtype=np.float64)
    scale = max(float(np.mean([p for p in prices if p > 0] or [1.0])), 1e-6)
    pr = np.asarray(prices, dtype=np.float64).reshape(J)
    cost[Nn:] = (np.maximum(pr, 0.0) / scale).astype(np.float32)
    price_col[Nn:] = pr
    prob = _Problem(
        E=Nn, req=req, count=count, feas=feas, cap=cap, cost=cost, price=price_col
    )
    prob.rows_owner = rows_owner
    prob.stay_owner = {Nn + j: j for j in range(J)}
    return prob


# ---------------------------------------------------------------------------
# deterministic rounding
# ---------------------------------------------------------------------------


def _round_provision(enc: EncodedInput, X: np.ndarray, prob: _Problem):
    """Greedy round-to-integral in solver order, guided by fractional mass.

    Pods round run by run through three tiers, mirroring the FFD kernel's
    placement semantics so the relaxation can only improve WHICH shapes
    open, never scatter what FFD would have packed:

    1. existing-node columns (sunk cost — filling free capacity is never
       dearer than opening a claim), ranked by descending X[s, col];
    2. ANY already-open claim, first-fit in creation order under the
       kernel's rules (cumulative fit vs the claim's chosen type,
       pool+type admissibility, pairwise group compatibility, non-empty
       joint offering) — cross-column joins are what keep multi-group
       fleets from opening one claim per group;
    3. a NEW claim from the macro columns ranked by descending X[s, col]
       (ties: price, then index — the fractional mass picks the shape),
       charging the pool limit on open.

    The codes stream feeds the SAME `_decode_from_codes` tail the device
    decode uses."""
    E = prob.E
    G, R = enc.group_req.shape
    S = len(enc.run_group)
    T = enc.pool_type.shape[1]
    Z, C = len(enc.zones), len(enc.capacity_types)
    node_rem = enc.node_free.astype(np.int64).copy()
    room = enc.pool_limit.astype(np.int64) - enc.pool_usage.astype(np.int64)
    pool_adm = [
        np.outer(enc.pool_zone[p], enc.pool_ct[p]) for p in range(enc.pool_zone.shape[0])
    ]
    claims: List[dict] = []
    offs = np.concatenate(([0], np.cumsum(enc.run_count))).astype(int)
    codes = np.full(int(offs[-1]), -1, dtype=np.int64)

    for s in range(S):
        g = int(enc.run_group[s])
        req = enc.group_req[g].astype(np.int64)
        gz = np.outer(enc.group_zone[g], enc.group_ct[g])
        cols = np.flatnonzero(prob.feas[s])
        if cols.size == 0:
            continue  # codes stay -1: unschedulable, surfaced as errors
        ranked = sorted(
            cols.tolist(), key=lambda n: (-float(X[s, n]), prob.price[n], n)
        )
        node_order = [n for n in ranked if n < E]
        macro_order = [n for n in ranked if n >= E]
        for k in range(int(enc.run_count[s])):
            pos = offs[s] + k
            placed = False
            for n in node_order:
                if (node_rem[n] >= req).all():
                    node_rem[n] -= req
                    codes[pos] = n
                    placed = True
                    break
            if placed:
                continue
            # first-fit into ANY open claim, creation order. Claims are
            # type-FLEXIBLE like the kernel's: a pod joins if any type in
            # the claim's still-viable set holds the cumulative sum with
            # a live offering — not just the macro column that opened it
            for ci, cl in enumerate(claims):
                if not enc.group_pool[g, cl["p"]]:
                    continue
                if not all(enc.group_pair[g, g2] for g2 in cl["gset"]):
                    continue
                ngz = cl["gz"] & gz
                if not ngz.any():
                    continue
                new_cum = cl["cum"] + req
                new_tset = [
                    t2 for t2 in cl["tset"]
                    if enc.group_compat_t[g, t2]
                    and (new_cum <= enc.type_alloc[t2].astype(np.int64)).all()
                    and (enc.offer_avail[t2] & ngz).any()
                ]
                if not new_tset:
                    continue
                cl["cum"] = new_cum
                cl["gset"].add(g)
                cl["gz"] = ngz
                cl["tset"] = new_tset
                codes[pos] = E + ci
                placed = True
                break
            if placed:
                continue
            for n in macro_order:
                p, t = prob.macro_pt[n]
                alloc = prob.alloc[n]
                cum0 = enc.pool_daemon[p].astype(np.int64) + req
                if not (cum0 <= alloc).all():
                    continue
                if not (prob.charge[n] <= room[p]).all():
                    continue
                zc0 = prob.adm[n] & gz
                if not zc0.any():
                    continue
                room[p] = room[p] - prob.charge[n]
                gz0 = gz & pool_adm[p]
                tset0 = [
                    t2 for t2 in map(int, np.flatnonzero(enc.pool_type[p]))
                    if enc.group_compat_t[g, t2]
                    and (cum0 <= enc.type_alloc[t2].astype(np.int64)).all()
                    and (enc.offer_avail[t2] & gz0).any()
                ]
                ci = len(claims)
                claims.append(
                    {"p": p, "cum": cum0, "gset": {g}, "gz": gz0,
                     "tset": tset0}
                )
                codes[pos] = E + ci
                break

    used = len(claims)
    c_mask = np.zeros((used, T), dtype=bool)
    c_zone = np.zeros((used, Z), dtype=bool)
    c_ct = np.zeros((used, C), dtype=bool)
    c_pool = np.zeros(used, dtype=np.int64)
    c_gmask = np.zeros((used, G), dtype=bool)
    c_cum = np.zeros((used, R), dtype=np.int64)
    for m, cl in enumerate(claims):
        p = cl["p"]
        c_pool[m] = p
        c_cum[m] = cl["cum"]
        for g in cl["gset"]:
            c_gmask[m, g] = True
        # widen the instance-type set to every shape that still satisfies
        # the claim (spot flexibility / min-values parity with the kernel's
        # narrowing claim masks); the chosen type qualifies by construction
        zc_any = np.zeros((Z, C), dtype=bool)
        for t2 in np.flatnonzero(enc.pool_type[p]):
            t2 = int(t2)
            if not all(enc.group_compat_t[g, t2] for g in cl["gset"]):
                continue
            if not (cl["cum"] <= enc.type_alloc[t2].astype(np.int64)).all():
                continue
            tz = enc.offer_avail[t2] & cl["gz"]
            if not tz.any():
                continue
            c_mask[m, t2] = True
            zc_any |= tz
        c_zone[m] = zc_any.any(axis=1)
        c_ct[m] = zc_any.any(axis=0)
    return _decode_from_codes(
        enc, codes, E, c_mask, c_zone, c_ct, c_pool, c_gmask, c_cum, used
    )


# ---------------------------------------------------------------------------
# the Solver wrapper
# ---------------------------------------------------------------------------


def find_convex(solver) -> Optional["ConvexSolver"]:
    """The ConvexSolver layer inside a wrapper chain, if one is wired
    (same real-`__dict__`-link walk as `concrete_backend`)."""
    seen = set()
    while id(solver) not in seen:
        seen.add(id(solver))
        if isinstance(solver, ConvexSolver):
            return solver
        d = getattr(solver, "__dict__", {})
        nxt = d.get("inner") or d.get("solver")
        if nxt is None or isinstance(nxt, (str, bytes)):
            break
        solver = nxt
    return None


def _out_of_scope(enc: EncodedInput) -> bool:
    """Inputs the convex model does not express (the reference's scope
    test): fallback groups, topology or affinity, nothing to place, V/Q
    constraint axes."""
    return bool(
        enc.group_fallback.any()
        or enc.has_topology
        or enc.has_affinity
        or enc.G == 0
        or (enc.v_kind is not None and getattr(enc.v_kind, "size", 0))
        or (enc.q_kind is not None and getattr(enc.q_kind, "size", 0))
    )


class ConvexSolver(Solver):
    """Per-NodePool global-optimization backend behind the Solver seam.

    Wraps the FFD executor (`inner` is a real __dict__ link, so
    `concrete_backend` keeps resolving through it to the device backend,
    whose device the convex program runs on: "cuda" unless the inner
    TorchSolver was given device="cpu"). Selection: a solve engages the
    convex path only when EVERY NodePool in the input resolves to "convex"
    — per-pool `solver_backend` (the `karpenter.sh/solver-backend` label)
    takes precedence over the operator-level default; a single pool
    resolving to FFD routes the whole solve verbatim to the inner backend.

    `convex_stats` holds the reference's counters and, beside them, what
    the reference exports as metrics and flight dumps (this package has no
    metrics plane yet): `solves_provision` / `solves_consolidate`
    (SOLVER_CONVEX_SOLVES by path), `fallback_<reason>`
    (SOLVER_CONVEX_FALLBACKS by reason) and `flight_dumps` (the
    convex_fallback dumps); SOLVER_CONVEX_ITERATIONS is `admm_iterations`."""

    def __init__(
        self,
        inner: Solver,
        max_iters: int = 400,
        tolerance: float = 1e-3,
        default_backend: str = "convex",
        max_macros: int = 256,
    ):
        self.inner = inner
        self.max_iters = int(max_iters)
        self.tolerance = float(tolerance)
        self.default_backend = default_backend
        self.max_macros = int(max_macros)
        dev = getattr(concrete_backend(inner), "device", None)
        self.device = torch.device("cuda" if dev is None else dev)
        self._lock = threading.Lock()
        self.convex_stats: Dict[str, int] = {
            "convex_solves": 0,
            "convex_fallbacks": 0,
            "convex_declines": 0,
            "admm_iterations": 0,
            "global_proposals": 0,
            "global_declines": 0,
            "prewarmed_buckets": 0,
            "solves_provision": 0,
            "solves_consolidate": 0,
            "flight_dumps": 0,
        }

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    # -- selection ----------------------------------------------------------

    def _resolve(self, pool) -> str:
        return getattr(pool, "solver_backend", None) or self.default_backend

    def selected(self, inp) -> bool:
        pools = getattr(inp, "nodepools", None) or []
        return bool(pools) and all(self._resolve(p) == "convex" for p in pools)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.convex_stats[key] = self.convex_stats.get(key, 0) + n

    # -- Solver seam --------------------------------------------------------

    def solve(self, inp):
        return self.solve_async(inp).result()

    def solve_async(self, inp) -> AsyncSolve:
        if not self.selected(inp):
            # per-pool backend labels (or an ffd default) deselect the
            # layer: counted as a decline so a mixed fleet is observable,
            # delegated verbatim so the result is the inner solver's own
            return self._delegate(inp, reason="unselected",
                                  count=self.default_backend == "convex")
        qinp = quantize_input(inp)
        from . import relax as rx

        if rx.plan(qinp) is not None:
            return self._delegate(inp, reason="preferences")
        enc = encode(qinp)
        if _out_of_scope(enc):
            return self._delegate(inp, reason="scope")
        prob = _build_provision(enc, self.max_macros)
        if prob is None:
            return self._delegate(inp, reason="shape")
        # no try: a K8 or K13 that fails to build or launch raises here
        handle = self._dispatch(prob)

        def finish():
            X, iters = self._fetch(handle)
            if iters < 0:
                return self._fallback(qinp, "nonconverged")
            S, N = prob.feas.shape
            res = _round_provision(enc, X[:S, :N], prob)
            if check_invariants(qinp, res):
                return self._fallback(qinp, "invariant")
            if not min_values_post_check(qinp, res):
                return self._fallback(qinp, "min_values")
            with self._lock:
                self.convex_stats["convex_solves"] += 1
                self.convex_stats["admm_iterations"] = iters
                self.convex_stats["solves_provision"] += 1
            if obsexplain.enabled():
                obsexplain.capture(qinp, res, "convex", enc=enc)
            return res

        return AsyncSolve(finish)

    # -- one-shot whole-cluster consolidation -------------------------------

    def consolidate_global(
        self, inp, candidates: Sequence[Tuple[str, float, frozenset]]
    ) -> Optional[dict]:
        """Propose the deletable candidate SUBSET for a multi-node
        consolidation decision. `candidates` is [(node_id, price,
        pod_uids)] in the controller's cost order; `inp` carries ALL
        candidates' pods as pending with every node still present.

        One device program: rows are (run x owning candidate) splits,
        columns are the surviving (non-candidate) nodes plus a priced stay
        column per candidate. A candidate whose rows all shed their stay
        mass below the epsilon can empty onto the surviving fleet — those
        form the proposal. Returns {"delete": [node_id...], "iterations",
        "stay_mass"} or None (decline: out of scope / non-converged / no
        >=2-candidate proposal). The caller MUST verify the proposal with
        one sequential simulate before commanding."""
        with self._lock:
            self.convex_stats["global_proposals"] += 1
        if not self.selected(inp):
            return self._global_decline()
        qinp = quantize_input(inp)
        from . import relax as rx

        if rx.plan(qinp) is not None:
            return self._global_decline()
        enc = encode(qinp)
        if _out_of_scope(enc):
            return self._global_decline()
        cand_ids = [c[0] for c in candidates]
        id2j = {nid: j for j, nid in enumerate(cand_ids)}
        uid2j: Dict[str, int] = {}
        for j, (_nid, _price, uids) in enumerate(candidates):
            for u in uids:
                uid2j[u] = j
        cand_e = {e for e, nid in enumerate(enc.node_ids) if nid in id2j}
        target_nodes = [e for e in range(len(enc.node_ids)) if e not in cand_e]
        # split each run by the candidate that owns its pods
        offs = np.concatenate(([0], np.cumsum(enc.run_count))).astype(int)
        owners: List[Tuple[int, int, int]] = []
        for s in range(len(enc.run_group)):
            by: Dict[int, int] = {}
            for u in enc.sorted_uids[offs[s] : offs[s + 1]].tolist():
                j = uid2j.get(str(u))
                if j is None:
                    return self._global_decline()  # foreign pending pod
                by[j] = by.get(j, 0) + 1
            for j in sorted(by):
                owners.append((int(enc.run_group[s]), by[j], j))
        if not owners:
            return self._global_decline()
        prob = _build_consolidate(
            enc, owners, target_nodes, [c[1] for c in candidates]
        )
        # no try: a K8 or K13 that fails to build or launch raises here
        X, iters = self._fetch(self._dispatch(prob))
        if iters < 0:
            self._count("fallback_consolidate_nonconverged")
            self._count("flight_dumps")
            return self._global_decline()
        with self._lock:
            self.convex_stats["admm_iterations"] = iters
            self.convex_stats["solves_consolidate"] += 1
        Nn = len(target_nodes)
        stay_mass = {j: 0.0 for j in range(len(candidates))}
        for i, (_g, _cnt, j) in enumerate(owners):
            stay_mass[j] = max(stay_mass[j], float(X[i, Nn + j]))
        delete = [cand_ids[j] for j in sorted(stay_mass) if stay_mass[j] < _STAY_EPS]
        if len(delete) < 2:
            return self._global_decline()
        return {
            "delete": delete,
            "iterations": iters,
            "stay_mass": {cand_ids[j]: round(m, 4) for j, m in stay_mass.items()},
        }

    # -- dispatch / fetch / prewarm -------------------------------------------

    def _dispatch(self, prob: _Problem):
        """Pad to the shape buckets, adopt the problem tensors into the
        inner backend's ArgumentArena (ns=("convex",): packed delta uploads
        and ledger accounting, shared with the FFD residency budget; a
        plain upload per array without one), and enqueue K13. Returns the
        device handles (X, conv)."""
        args = pad_problem(prob)
        arena = getattr(concrete_backend(self.inner), "arena", None)
        if arena is not None:
            args = arena.adopt(args, (None,) * len(args), ns=("convex",))
        else:
            args = tuple(torch.from_numpy(a).to(self.device) for a in args)
        return admm_pack(*args, self.tolerance, max_iters=self.max_iters)

    @staticmethod
    def _fetch(handle) -> Tuple[np.ndarray, int]:
        """(X as numpy, the latch) in one device-to-host message: the latch
        rides as the last word of X's buffer."""
        X, conv = handle
        if X.is_cuda:
            flat = torch.cat([X.reshape(-1), conv.reshape(1).view(torch.float32)]).cpu().numpy()
            return flat[:-1].reshape(X.shape), int(flat[-1:].view(np.int32)[0])
        return X.numpy(), int(conv)

    def prewarm_aot(self, *args, **kwargs):
        """Build the kernel libraries and launch K13 once on each bucket of
        the small lattice after delegating the inner backend's own prewarm
        (operator boot path); a failed build or launch raises."""
        inner_fn = getattr(self.inner, "prewarm_aot", None)
        out = inner_fn(*args, **kwargs) if callable(inner_fn) else None
        n = 0
        for Sp, Np in PREWARM_BUCKETS:
            z = dict(dtype=torch.float32, device=self.device)
            admm_pack(torch.zeros((Sp, 4), **z), torch.zeros(Sp, dtype=torch.int32,
                                                            device=self.device),
                      torch.zeros((Np, 4), **z), torch.zeros(Np, **z),
                      torch.zeros((Sp, Np), dtype=torch.bool, device=self.device),
                      self.tolerance, max_iters=self.max_iters)
            n += 1
        with self._lock:
            self.convex_stats["prewarmed_buckets"] = n
        return out

    # -- decline / fallback plumbing ----------------------------------------

    def _delegate(self, inp, reason: Optional[str] = None, count: bool = True) -> AsyncSolve:
        """Verbatim delegation to the inner solver."""
        if count and reason is not None:
            with self._lock:
                self.convex_stats["convex_declines"] += 1
        fn = getattr(self.inner, "solve_async", None)
        if callable(fn):
            return fn(inp)
        return AsyncSolve(lambda: self.inner.solve(inp))

    def _fallback(self, qinp, reason: str):
        """Loud fallback: counted (fallbacks, by reason, and the flight
        dump the reference writes), then the inner FFD solver answers."""
        with self._lock:
            self.convex_stats["convex_fallbacks"] += 1
        self._count(f"fallback_{reason}")
        self._count("flight_dumps")
        return self.inner.solve(qinp)

    def _global_decline(self) -> None:
        with self._lock:
            self.convex_stats["global_declines"] += 1
        return None
