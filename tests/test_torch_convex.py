"""The port's convex backend (karpenter_tpu_torch/solver/convex.py and its
device program, solver/cuda/convex.py admm_pack) against the JAX
package's solver/convex.py, on the CPU.

(a) The kernel function: the port's plain admm_pack against the JAX
    admm_pack (jitted on the CPU) on seeded problems (S <= 64, N <= 128,
    R 1-4: sunk node columns, then priced columns with room, every row
    keeping one) and on adversarial tables (padding rows, a row with no
    feasible column, all-zero cost, tol 10 and 0, max_iters 1, R = 1 and
    R = 16, shapes from 16 x 16 up). X agrees within X_TOL and the latch is
    equal, or one apart where JAX's own residual at that iteration lies
    within RESID_NOISE of tol. Each problem is compared at the longest
    horizon (400, 100, 25 or 10 iterations) at which JAX agrees with
    itself within SENS_TOL when every float input is scaled by 1 + 2^-22
    (a few ulps): where the capacity split puts the damped dynamics on a
    limit cycle, the iterate is chaotic, and float noise (exp, the order of
    the sums, both of which differ between XLA and PyTorch in the last
    bit) grows to O(0.1) in X within a few dozen iterations, in JAX against
    itself as much as against the port. A problem is never skipped: at 10
    iterations every one is held. chip_smoke.py's check of the kernel
    against the plain version fails a stand-in kernel with a planted
    schedule fault, on the config-5-shaped universe too.
(b) The problem builders: _build_provision and the vectorised
    _build_consolidate equal the JAX ones field by field on the fleets of
    tests/test_convex_backend.py and on a small config-5-shaped universe.
(c) Rounding: _round_provision fed the JAX X equals the JAX rounding.
(d) The seam: ConvexSolver(TorchSolver(device="cpu")) against JAX
    ConvexSolver(TPUSolver()): placements, error keys, claims and the JAX
    package's convex_stats keys, on tests/test_convex_backend.py's fleets
    (each reused test named in a comment), tools/explain_diff.py's
    scenarios, the max_iters=1 loud fallback, the per-pool label decline,
    verbatim delegation, consolidate_global's proposal and its decline,
    and the small config-5-shaped universe, where the proposal deletes
    more candidates than the absorbers can hold, as in the reference.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.api import wellknown as jwk
from karpenter_tpu.provisioning.scheduler import ExistingNode, SolverInput
from karpenter_tpu.solver import convex as jcv
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.encode import encode as jencode
from karpenter_tpu.solver.encode import quantize_input as jquantize
from karpenter_tpu.utils.resources import Resources
from karpenter_tpu_torch.solver import convex as tcv
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.convert import problem_to_torch
from karpenter_tpu_torch.solver.cuda import convex as tcc
from karpenter_tpu_torch.solver.encode import encode as tencode
from karpenter_tpu_torch.solver.encode import quantize_input as tquantize
from tests.test_convex_backend import mknode, mktype
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import to_port

torch.set_num_threads(1)

X_TOL = 1e-4  # |X_port - X_jax| at the compared horizon
SENS_TOL = 1e-5  # JAX against itself under a few-ulp input change: "not chaotic"
RESID_NOISE = 1e-6  # a latch one iteration apart: |resid - tol| within this
HORIZONS = (400, 100, 25, 10)

# ---------------------------------------------------------------------------
# (a) the kernel function
# ---------------------------------------------------------------------------


def _padded(n: int) -> int:
    return max(16, -(-n // 16) * 16)


def seeded_problem(seed: int):
    """A padded admm_pack argument tuple shaped like the backend's problems:
    E sunk node columns (cost 0, little room), then priced columns with
    room; every real row keeps one priced column feasible."""
    rng = np.random.default_rng(seed)
    S, N, R = int(rng.integers(1, 65)), int(rng.integers(2, 129)), int(rng.integers(1, 5))
    Sp, Np = _padded(S), _padded(N)
    E = int(rng.integers(0, N))
    req = np.zeros((Sp, R), np.float32)
    cnt = np.zeros(Sp, np.int32)
    req[:S] = rng.integers(1, 8, (S, R))
    cnt[:S] = rng.integers(1, 6, S)
    cap = np.zeros((Np, R), np.float32)
    cost = np.zeros(Np, np.float32)
    cap[:E] = rng.integers(0, 24, (E, R))
    cap[E:N] = rng.integers(16, 200, (N - E, R))
    cost[E:N] = rng.uniform(0.1, 2.0, N - E)
    feas = np.zeros((Sp, Np), bool)
    feas[:S, :N] = rng.random((S, N)) < rng.uniform(0.2, 0.9)
    feas[np.arange(S), rng.integers(E, N, S)] = True
    return req, cnt, cap, cost, feas


def _jax(args, tol, iters):
    X, c = jcv.admm_pack(*args, tol, max_iters=iters)
    return np.asarray(X), int(c)


def _port(args, tol, iters):
    X, c = tcc.admm_pack(*[torch.from_numpy(a) for a in args], tol, max_iters=iters)
    assert X.dtype == torch.float32 and c.dtype == torch.int32 and c.dim() == 0
    return X.numpy(), int(c)


def _jax_resid(args, tol, it):
    """JAX's max |X_it - X_(it-1)|: the residual its latch compared at
    iteration it (the scan is deterministic, so two horizons give it)."""
    return float(np.abs(_jax(args, tol, it)[0] - _jax(args, tol, it - 1)[0]).max())


def _few_ulps(args):
    """Every float input scaled by 1 + 2^-22 (a change of a few ulps)."""
    req, cnt, cap, cost, feas = args
    f = np.float32(1 + 2**-22)
    return (req * f).astype(np.float32), cnt, (cap * f).astype(np.float32), \
        (cost * f).astype(np.float32), feas


def assert_admm_parity(args, tol=1e-3, horizons=HORIZONS) -> tuple:
    """Hold the port's plain admm_pack to JAX's at the longest horizon of
    `horizons` at which JAX is reproducible under a few-ulp input change
    (the last horizon always). Returns (horizon, X gap, JAX self gap)."""
    for k in horizons:
        Xj, cj = _jax(args, tol, k)
        sens = float(np.abs(_jax(_few_ulps(args), tol, k)[0] - Xj).max()) if k > horizons[-1] else 0.0
        if sens > SENS_TOL:
            continue
        Xt, ct = _port(args, tol, k)
        gap = float(np.abs(Xt - Xj).max())
        assert gap <= X_TOL, (k, gap)
        if ct != cj:
            assert abs(ct - cj) == 1 and min(ct, cj) >= 1, (k, ct, cj)
            resid = _jax_resid(args, tol, max(ct, cj) - 1 if min(ct, cj) == -1 else min(ct, cj))
            assert abs(resid - tol) <= RESID_NOISE, (k, ct, cj, resid)
        return k, gap, sens
    raise AssertionError("unreachable: the last horizon is always compared")


@pytest.mark.parametrize("seed", range(20))
def test_admm_pack_matches_jax_seeded(seed):
    k, gap, _ = assert_admm_parity(seeded_problem(seed))
    assert k in HORIZONS and gap <= X_TOL


def _adversarial():
    rng = np.random.default_rng(7)
    out = {}
    base = seeded_problem(3)
    req, cnt, cap, cost, feas = (a.copy() for a in base)
    out["padding_rows"] = (req, cnt, cap, cost, feas)  # rows past S are all padding
    req, cnt, cap, cost, feas = (a.copy() for a in base)
    feas[1, :] = False  # a real row with no feasible column (gmin = +inf)
    out["row_without_column"] = (req, cnt, cap, cost, feas)
    req, cnt, cap, cost, feas = (a.copy() for a in base)
    out["zero_cost"] = (req, cnt, cap, np.zeros_like(cost), feas)
    Sp, Np = 16, 16
    out["tiny_R1"] = (rng.integers(1, 5, (Sp, 1)).astype(np.float32),
                      rng.integers(0, 4, Sp).astype(np.int32),
                      rng.integers(0, 30, (Np, 1)).astype(np.float32),
                      rng.uniform(0, 1, Np).astype(np.float32), rng.random((Sp, Np)) < 0.5)
    Sp, Np, R = 32, 48, 16
    out["R16"] = (rng.integers(1, 5, (Sp, R)).astype(np.float32),
                  rng.integers(1, 4, Sp).astype(np.int32),
                  rng.integers(20, 400, (Np, R)).astype(np.float32),
                  rng.uniform(0, 1, Np).astype(np.float32), rng.random((Sp, Np)) < 0.6)
    out["all_padding"] = (np.zeros((16, 2), np.float32), np.zeros(16, np.int32),
                          np.zeros((16, 2), np.float32), np.zeros(16, np.float32),
                          np.zeros((16, 16), bool))
    return out


ADVERSARIAL = _adversarial()


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_admm_pack_matches_jax_adversarial(name):
    args = ADVERSARIAL[name]
    assert_admm_parity(args)
    if name == "row_without_column":
        X, _ = _port(args, 1e-3, 400)
        assert (X[1] == 0).all()
    if name == "all_padding":
        X, c = _port(args, 1e-3, 400)
        assert (X == 0).all() and c == 1  # resid 0 < tol at the first iteration


@pytest.mark.parametrize("tol,want", [(10.0, 1), (0.0, -1)])
def test_admm_pack_latch_edges(tol, want):
    """tol = 10: every residual is under it, the latch fires at iteration 1;
    tol = 0: never. Every iteration still runs: X is the last iterate."""
    args = seeded_problem(5)
    for iters in (1, 30):
        Xj, cj = _jax(args, tol, iters)
        Xt, ct = _port(args, tol, iters)
        assert cj == ct == want
        assert np.abs(Xt - Xj).max() <= X_TOL
    assert np.abs(_port(args, tol, 30)[0] - _port(args, tol, 1)[0]).max() > 0


def test_admm_pack_max_iters_one_and_zero():
    args = seeded_problem(11)
    for iters in (0, 1):
        Xj, cj = _jax(args, 1e-3, iters)
        Xt, ct = _port(args, 1e-3, iters)
        assert cj == ct and np.abs(Xt - Xj).max() <= X_TOL


def test_admm_pack_tolerance_as_tensor():
    args = seeded_problem(2)
    a = _port(args, 1e-3, 40)
    X, c = tcc.admm_pack(*[torch.from_numpy(x) for x in args],
                         torch.tensor([1e-3], dtype=torch.float32), max_iters=40)
    assert torch.equal(X, torch.from_numpy(a[0])) and int(c) == a[1]


def test_admm_pack_cuda_wrapper_checks():
    """The kernel path takes CUDA tensors of the stated types only."""
    args = [torch.from_numpy(a) for a in seeded_problem(0)]
    with pytest.raises(ValueError):
        tcc._admm_pack_cuda(*args, 1e-3, 10)


# ---------------------------------------------------------------------------
# (b) the problem builders
# ---------------------------------------------------------------------------


_FIELDS = ("E", "req", "count", "feas", "cap", "cost", "price", "macro_pt", "alloc", "charge",
           "adm", "stay_owner", "rows_owner")


def assert_problem_equal(got, want):
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), f
            for k in b:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (f, k)
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (f, k)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f
        else:
            assert a == b, f


def _encs(inp):
    return jencode(jquantize(inp)), tencode(tquantize(to_port(inp)))


def _random_fleets():
    # tests/test_convex_backend.py TestFeasibilityParity.test_randomized_fleets_never_trip_the_gate
    rng = random.Random(20419)
    out = []
    for trial in range(6):
        n_nodes = rng.randint(0, 3)
        nodes = [mknode(f"n{trial}-{j}", zone=ZONES[j % len(ZONES)],
                        cpu=str(rng.choice([4, 8, 16]))) for j in range(n_nodes)]
        pods = [mkpod(f"t{trial}-p{i}", cpu=str(rng.choice([1, 2, 3])),
                      mem=f"{rng.choice([1, 2, 4])}Gi") for i in range(rng.randint(4, 24))]
        out.append(SolverInput(pods=pods, nodes=nodes, nodepools=[pool()], zones=ZONES,
                               capacity_types=("on-demand", "spot")))
    return out


def _existing_first():
    # tests/test_convex_backend.py TestFeasibilityParity.test_existing_capacity_filled_first
    nodes = [mknode("n1"), mknode("n2", zone="zone-1b")]
    pods = [mkpod(f"q{i:02d}", cpu="3", mem="4Gi") for i in range(8)]
    return SolverInput(pods=pods, nodes=nodes, nodepools=[pool()], zones=ZONES,
                       capacity_types=("on-demand", "spot"))


def _uniform():
    # tests/test_convex_backend.py TestQualityDominance.test_uniform_fleet_ties_ffd
    t = mktype("std.xlarge", 4, 16, 1.0)
    pods = [mkpod(f"u{i:02d}", cpu="1", mem="1Gi") for i in range(12)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool(types=[t])], zones=ZONES,
                       capacity_types=("on-demand",))


def _contention(n_pods=96):
    # tests/test_convex_backend.py TestQualityDominance._contention_input
    boutique = mktype("boutique.xlarge", 4, 16, 1.0)
    warehouse = mktype("warehouse.4xlarge", 16, 64, 0.9)
    pools = [pool("boutique", weight=100, types=[boutique]),
             pool("warehouse", weight=0, types=[warehouse])]
    pods = [mkpod(f"w{i:03d}", cpu="1", mem="1Gi") for i in range(n_pods)]
    return SolverInput(pods=pods, nodes=[], nodepools=pools, zones=ZONES,
                       capacity_types=("on-demand",))


def _catalog_fleets():
    # tests/test_convex_backend.py TestQualityDominance.test_convex_never_worse_on_catalog_fleets
    rng = random.Random(77)
    out = []
    for trial in range(3):
        pods = [mkpod(f"c{trial}-{i}", cpu=str(rng.choice([1, 2])),
                      mem=f"{rng.choice([1, 2])}Gi") for i in range(rng.randint(8, 32))]
        out.append(SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES,
                               capacity_types=("on-demand", "spot")))
    return out


PROVISION_FLEETS = {
    **{f"random{i}": f for i, f in enumerate(_random_fleets())},
    "existing_first": _existing_first(),
    "uniform": _uniform(),
    "contention": _contention(),
    **{f"catalog{i}": f for i, f in enumerate(_catalog_fleets())},
}


@pytest.mark.parametrize("name", sorted(PROVISION_FLEETS))
def test_build_provision_matches_jax(name):
    je, te = _encs(PROVISION_FLEETS[name])
    for macros in (256, 2):
        want = jcv._build_provision(je, macros)
        got = tcv._build_provision(te, macros)
        assert_problem_equal(got, want)


def _consolidation_input(surv_cpu="16"):
    # tests/test_convex_backend.py TestConsolidateGlobal (both tests)
    t = mktype("std.4xlarge", 16, 64, 0.9)
    nodes = [mknode(f"c{j}") for j in range(1, 4)]
    nodes.append(mknode("surv", cpu=surv_cpu, mem="64Gi"))
    pods = [mkpod(f"m{j}{k}", cpu="1", mem="1Gi") for j in range(3) for k in range(2)]
    inp = SolverInput(pods=pods, nodes=nodes, nodepools=[pool(types=[t])], zones=ZONES,
                      capacity_types=("on-demand",))
    cands = [(f"c{j}", 0.5, frozenset({f"m{j - 1}{k}" for k in range(2)})) for j in range(1, 4)]
    return inp, cands


def config5_like(n_cand=40, n_abs=30, n_full=100):
    """bench.py build_config5_universe's shape at a small size: candidates
    with one small pod each (pending here), absorbers with one pod's room,
    full nodes; the candidates' list as consolidate_global takes it."""
    import bench

    inp = bench.build_input(0)
    sizes = [("500m", "512Mi"), ("500m", "1Gi"), ("250m", "512Mi"), ("750m", "768Mi")]

    def node(kind, j, cpu, mem, pods):
        free = Resources.parse({"cpu": cpu, "memory": mem})
        free["pods"] = pods
        return ExistingNode(id=f"{kind}-{j:05d}", labels={
            jwk.ZONE_LABEL: f"zone-1{'abc'[j % 3]}", jwk.CAPACITY_TYPE_LABEL: "on-demand",
            jwk.HOSTNAME_LABEL: f"{kind}-{j:05d}", jwk.ARCH_LABEL: "amd64",
            jwk.OS_LABEL: "linux"}, taints=[], free=free)

    nodes = [node("cand", j, "7", "30Gi", 100) for j in range(n_cand)]
    nodes += [node("abs", j, "800m", "1Gi", 1) for j in range(n_abs)]
    nodes += [node("full", j, "0", "0", 0) for j in range(n_full)]
    pods = [mkpod(f"cp{j:05d}", cpu=sizes[j % 4][0], mem=sizes[j % 4][1]) for j in range(n_cand)]
    cands = [(f"cand-{j:05d}", 1.0, frozenset({f"cp{j:05d}"})) for j in range(n_cand)]
    return SolverInput(pods=pods, nodes=nodes, nodepools=inp.nodepools, zones=inp.zones,
                       capacity_types=inp.capacity_types), cands


def _owners_and_targets(enc, candidates):
    """consolidate_global's row split and surviving nodes (the same code in
    both packages), to feed the builders one problem."""
    id2j = {c[0]: j for j, c in enumerate(candidates)}
    uid2j = {u: j for j, c in enumerate(candidates) for u in c[2]}
    cand_e = {e for e, nid in enumerate(enc.node_ids) if nid in id2j}
    targets = [e for e in range(len(enc.node_ids)) if e not in cand_e]
    offs = np.concatenate(([0], np.cumsum(enc.run_count))).astype(int)
    owners = []
    for s in range(len(enc.run_group)):
        by = {}
        for u in enc.sorted_uids[offs[s]:offs[s + 1]].tolist():
            by[uid2j[str(u)]] = by.get(uid2j[str(u)], 0) + 1
        owners += [(int(enc.run_group[s]), by[j], j) for j in sorted(by)]
    return owners, targets


CONSOLIDATION_CASES = {
    "proposal": lambda: _consolidation_input("16"),
    "infeasible": lambda: _consolidation_input("2"),
    "config5_like": config5_like,
}


@pytest.mark.parametrize("name", sorted(CONSOLIDATION_CASES))
def test_build_consolidate_matches_jax(name):
    inp, cands = CONSOLIDATION_CASES[name]()
    je, te = _encs(inp)
    owners, targets = _owners_and_targets(je, cands)
    assert (owners, targets) == _owners_and_targets(te, cands)
    prices = [c[1] for c in cands]
    assert_problem_equal(tcv._build_consolidate(te, owners, targets, prices),
                         jcv._build_consolidate(je, owners, targets, prices))


def _config5_like_args():
    inp, cands = config5_like(40, 30, 100)
    _, te = _encs(inp)
    owners, targets = _owners_and_targets(te, cands)
    prob = tcv._build_consolidate(te, owners, targets, [c[1] for c in cands])
    return [torch.from_numpy(a) for a in tcv.pad_problem(prob)]


K13_FAULTS = {
    # (table, constant of solver/convex.py the "kernel" computes with, value)
    "config5_like_beta_fixed": ("config5_like", "_TAU", float("inf")),
    "config5_like_eta_fixed": ("config5_like", "_ANNEAL", float("inf")),
    "seeded_overload_dropped": ("seed1", "_RHO", 0.0),
}


@pytest.mark.parametrize("name", sorted(K13_FAULTS) + ["config5_like_no_fault"])
def test_chip_smoke_k13_hold_catches_planted_faults(name, monkeypatch):
    """chip_smoke.py's K13 check (hold_admm) with a stand-in kernel, the
    plain version computing with one schedule constant changed: a damping
    that does not decay, a step size that does not anneal, no overload
    term. On the config-5-shaped universe both runs settle to one fixed
    point, so only the transient horizons catch the first two; the plain
    version against itself passes."""
    import chip_smoke

    table, const, value = K13_FAULTS.get(name, ("config5_like", None, None))
    args = (_config5_like_args() if table == "config5_like"
            else [torch.from_numpy(a) for a in chip_smoke.admm_seeded(1)])
    plain = tcc.admm_pack_plain

    def stand_in(*a, max_iters):
        if const is None:
            return plain(*a, max_iters)
        saved = getattr(tcv, const)
        setattr(tcv, const, value)
        try:
            return plain(*a, max_iters)
        finally:
            setattr(tcv, const, saved)

    monkeypatch.setattr(tcc, "admm_pack", stand_in)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    if const is None:
        held = chip_smoke.hold_admm(args, 1e-3, 400)
        assert held["horizon"] == 400 and held["err"] == 0 and sorted(held["short"]) == [1, 2, 10, 25, 100]
    else:
        with pytest.raises(AssertionError, match="admm_pack disagrees"):
            chip_smoke.hold_admm(args, 1e-3, 400)


def test_problem_to_torch_pads_as_dispatch():
    je, _ = _encs(_contention())
    prob = jcv._build_provision(je, 256)
    got = problem_to_torch(prob, "cpu")
    S, N = prob.feas.shape
    assert got[4].shape == (_padded(S), _padded(N)) and got[4].dtype == torch.bool
    assert [t.dtype for t in got[:4]] == [torch.float32, torch.int32, torch.float32,
                                          torch.float32]
    assert np.array_equal(got[4][:S, :N].numpy(), prob.feas) and not got[4][S:].any()
    assert np.array_equal(got[2][:N].numpy(), prob.cap)


# ---------------------------------------------------------------------------
# (c) rounding
# ---------------------------------------------------------------------------


def _claims(res):
    return [(c.nodepool, sorted(c.instance_type_names), list(c.pod_uids),
             sorted(c.requests.items())) for c in res.claims]


def assert_result_equal(got, want):
    assert got.placements == want.placements
    assert set(got.errors) == set(want.errors)
    assert _claims(got) == _claims(want)


@pytest.mark.parametrize("name", sorted(PROVISION_FLEETS))
def test_round_provision_matches_jax(name):
    je, te = _encs(PROVISION_FLEETS[name])
    jp = jcv._build_provision(je, 256)
    tp = tcv._build_provision(te, 256)
    X, _ = _jax(tcv.pad_problem(jp), 1e-3, 400)
    S, N = jp.feas.shape
    assert_result_equal(tcv._round_provision(te, X[:S, :N], tp),
                        jcv._round_provision(je, X[:S, :N], jp))


# ---------------------------------------------------------------------------
# (d) the seam
# ---------------------------------------------------------------------------


def _stats_equal(got, want):
    assert {k: got.convex_stats[k] for k in want.convex_stats} == want.convex_stats


def assert_convex_parity(inp, **kw):
    want_cv = jcv.ConvexSolver(TPUSolver(), **kw)
    got_cv = tcv.ConvexSolver(TorchSolver(device="cpu"), **kw)
    want = want_cv.solve(inp)
    got = got_cv.solve(to_port(inp))
    assert_result_equal(got, want)
    _stats_equal(got_cv, want_cv)
    return got, got_cv


@pytest.mark.parametrize("name", sorted(PROVISION_FLEETS))
def test_convex_solver_matches_jax(name):
    got, cv = assert_convex_parity(PROVISION_FLEETS[name])
    assert cv.convex_stats["convex_fallbacks"] == 0 and cv.convex_stats["convex_solves"] == 1
    assert cv.convex_stats["solves_provision"] == 1


def explain_scenario(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "explain_diff.py"
    spec = importlib.util.spec_from_file_location("explain_diff", path)
    xd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(xd)
    return xd.build_scenario(name)


@pytest.mark.parametrize("name,claims", [("uniform", 3), ("rightsize", 6), ("split", 1)])
def test_quality_scenarios_match_jax(name, claims):
    # bench.py _quality_run's scenarios (tools/explain_diff.py build_scenario)
    got, cv = assert_convex_parity(explain_scenario(name))
    assert len(got.claims) == claims and not got.errors
    assert cv.convex_stats["convex_fallbacks"] == 0


def test_nonconvergence_falls_back_loudly():
    # tests/test_convex_backend.py TestLoudFallback.test_nonconvergence_falls_back_loudly
    pods = [mkpod(f"p{i}", cpu="1", mem="1Gi") for i in range(12)]
    inp = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES,
                      capacity_types=("on-demand", "spot"))
    got, cv = assert_convex_parity(inp, max_iters=1)
    assert not got.errors
    assert (cv.convex_stats["convex_fallbacks"], cv.convex_stats["convex_solves"]) == (1, 0)
    assert cv.convex_stats["fallback_nonconverged"] == 1 and cv.convex_stats["flight_dumps"] == 1


def test_per_pool_backend_label_declines():
    # tests/test_convex_backend.py TestLoudFallback.test_per_pool_backend_label_declines
    p1, p2 = pool("a"), pool("b")
    p2.solver_backend = "ffd"
    inp = SolverInput(pods=[mkpod("p0"), mkpod("p1")], nodes=[], nodepools=[p1, p2],
                      zones=ZONES, capacity_types=("on-demand", "spot"))
    got, cv = assert_convex_parity(inp)
    assert (cv.convex_stats["convex_declines"], cv.convex_stats["convex_solves"]) == (1, 0)


def test_unselected_solve_is_inner_result_verbatim():
    # tests/test_convex_backend.py TestKnobsOffInertness.test_unselected_solve_is_inner_result_verbatim
    inp = to_port(SolverInput(pods=[mkpod("p0"), mkpod("p1")], nodes=[], nodepools=[pool()],
                              zones=ZONES, capacity_types=("on-demand", "spot")))
    inner = TorchSolver(device="cpu")
    cv = tcv.ConvexSolver(inner, default_backend="ffd")
    direct = inner.solve(inp)
    wrapped = cv.solve(inp)
    assert wrapped.placements == direct.placements
    assert [c.requests for c in wrapped.claims] == [c.requests for c in direct.claims]
    assert cv.convex_stats["convex_solves"] == 0 and cv.convex_stats["convex_declines"] == 0
    assert tcv.find_convex(cv) is cv and tcv.find_convex(inner) is None
    assert cv.device == torch.device("cpu")


def _global_parity(inp, cands, **kw):
    want_cv = jcv.ConvexSolver(TPUSolver(), **kw)
    got_cv = tcv.ConvexSolver(TorchSolver(device="cpu"), **kw)
    dispatches = []
    inner = got_cv._dispatch
    got_cv._dispatch = lambda prob: dispatches.append(1) or inner(prob)
    want = want_cv.consolidate_global(inp, cands)
    got = got_cv.consolidate_global(to_port(inp), cands)
    assert (got is None) == (want is None)
    if want is not None:
        assert got["delete"] == want["delete"] and got["iterations"] == want["iterations"]
        assert got["stay_mass"].keys() == want["stay_mass"].keys()
        assert all(abs(got["stay_mass"][k] - want["stay_mass"][k]) <= 2e-4 for k in want["stay_mass"])
    _stats_equal(got_cv, want_cv)
    return got, got_cv, len(dispatches)


def test_consolidate_global_proposal():
    # tests/test_convex_backend.py TestConsolidateGlobal.test_one_shot_proposal_and_dispatch_budget
    got, cv, dispatches = _global_parity(*_consolidation_input("16"))
    assert sorted(got["delete"]) == ["c1", "c2", "c3"] and dispatches == 1
    assert cv.convex_stats["solves_consolidate"] == 1


def test_consolidate_global_infeasible_declines():
    # tests/test_convex_backend.py TestConsolidateGlobal.test_infeasible_consolidation_declines
    got, cv, _ = _global_parity(*_consolidation_input("2"))
    assert got is None and cv.convex_stats["global_declines"] == 1


def test_consolidate_global_config5_like_over_deletes():
    """The reference's config-5 finding at a small size: each row's mass
    starts spread over the 30 absorbers, the latch fires early, and the
    proposal deletes every candidate although only the absorbers' 30 pods
    can move (ROADMAP §C); the controller's verify simulate would reject
    it. At config 5's full size the latch fires at iteration 1."""
    inp, cands = config5_like(40, 30, 100)
    got, cv, dispatches = _global_parity(inp, cands)
    assert dispatches == 1 and 1 <= got["iterations"] <= 10, got["iterations"]
    assert len(got["delete"]) == 40 > 30


def test_consolidate_global_nonconverged_declines():
    inp, cands = _consolidation_input("16")
    got, cv, _ = _global_parity(inp, cands, max_iters=1, tolerance=0.0)
    assert got is None and cv.convex_stats["fallback_consolidate_nonconverged"] == 1


def test_prewarm_launches_each_bucket():
    cv = tcv.ConvexSolver(TorchSolver(device="cpu"), max_iters=5)
    cv.prewarm_aot()
    assert cv.convex_stats["prewarmed_buckets"] == len(tcv.PREWARM_BUCKETS) == 3


def test_convex_problem_adopts_into_the_arena():
    """The problem's float32 and bool segments cross the arena's packed
    upload byte for byte (K8's plain version on the CPU); an unchanged
    problem uploads nothing the second time."""
    inner = TorchSolver(device="cpu")
    cv = tcv.ConvexSolver(inner)
    inp = to_port(_contention())
    inner.ledger.begin_solve()
    r1 = cv.solve(inp)
    cold = inner.ledger.solve["h2d_bytes"]
    je, _ = _encs(_contention())
    prob = jcv._build_provision(je, 256)
    assert cold == sum(a.nbytes for a in tcv.pad_problem(prob))
    inner.ledger.begin_solve()
    r2 = cv.solve(inp)
    assert inner.ledger.solve["h2d_bytes"] == 0 and r2.placements == r1.placements
