"""The port's mesh-sharded provisioning solve and candidate-sharded
consolidation against the JAX package, on the CPU under a virtual mesh.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py forces;
the port's side enters `virtual_devices(8)`, its counterpart (on the CPU
every slot is the CPU, so each "launch" runs the plain versions over the
slots' blocks).

- Kernel level: the plain `ffd_solve_sharded` and
  `ffd_solve_sharded_sparse` (K17's / K17s's plain versions) equal the JAX
  functions on the same host_kernel_args blocked by `mesh_run_blocks`, every
  FFDOutput leaf exactly, at Nd 2, 4 and 8, fast and zoned, on fleets built
  by tests/test_mesh_sharded_solve.py's builders; each lane equals
  ffd_solve_plain on its block alone.
- Solver level: `TorchSolver(shards=n, device="cpu")` decides as
  `TPUSolver(shards=n)` and as `TorchSolver(device="cpu")` on every scenario
  of tests/test_mesh_sharded_solve.py, with equal sharded stats and equal
  h2d_bytes / h2d_shard_bytes / h2d_msgs on the ledger.
- Arena: the invalidation scenario of tests/test_transfer_arena.py (a
  failed sharded dispatch, then invalidate_arena() drops the per-slot
  argument residency and the block-boundary carries).
- Consolidation: `simulate_subsets` under virtual_devices(n) equals the JAX
  one field by field on a replicated batch, a heterogeneous batch and a
  mixed-axis fleet (tests/test_parallel_sharded.py's scenarios as
  consolidation universes); the evaluator's verdicts and universe upload
  equal the JAX evaluator's on a candidate mesh.
- The mesh itself: slot dealing, the per-device split of a candidate
  batch, caches keyed on the slot list.

Every output is an integer or a bit pattern: the tolerance is exact
equality.
"""

import random

import numpy as np
import pytest
import torch

import jax

import tests.test_mesh_sharded_solve as jm
from karpenter_tpu.api import wellknown as wk
from karpenter_tpu.api.objects import PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu.disruption import batched as jbatched
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.tpu import consolidate as jcons
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.disruption import batched as tbatched
from karpenter_tpu_torch.parallel import sharded as tsh
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.convert import args_to_torch, output_to_numpy
from karpenter_tpu_torch.solver.cuda import consolidate as tcons
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_batched import FLEETS, materialize
from tests.test_torch_consolidate import assert_outputs_equal, fleet, subsets_for, universe_args
from tests.test_torch_jax_release import release_if_crowded
from tests.test_torch_relax import to_port
from tests.test_transfer_arena import _inp
from tests.test_zone_device import ZONES, mknode, mkpod, pool

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _release_jax_executables():
    """Drop the JAX side's compiled programs after a test that leaves the
    process past its map budget (tests/test_torch_jax_release.py). The
    sharded programs on 8 virtual devices are many and large: kept, this
    module's alone map ~37 000 memory regions into one worker."""
    yield
    release_if_crowded()

SHARD_STATS = ("sharded_solves", "shard_fixup_runs", "sharded_fallbacks",
               "shard_resume_solves", "shard_resume_runs_skipped")
LEDGER_KEYS = ("h2d_bytes", "h2d_shard_bytes", "h2d_msgs")


# ------------------------------------------------------------------ fleets


def _zone_fleet(n):
    tsc = TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL,
                                   label_selector={"app": "w"})
    return [mkpod(f"v{i:02d}", cpu="2", mem="4Gi", labels={"app": "w"}, topology_spread=[tsc])
            for i in range(n)]


def random_input(seed):
    return SolverInput(pods=jm._random_fleet(random.Random(seed), 90 + 10 * seed), nodes=[],
                       nodepools=[pool()], zones=ZONES)


def nodes_input():
    return SolverInput(pods=jm._random_fleet(random.Random(7), 80),
                       nodes=[mknode(f"n{i}", ZONES[i % 3]) for i in range(5)],
                       nodepools=[pool()], zones=ZONES)


def fixup_input():
    pods = [jm._mkpod(f"p{i:03d}", f"{2000 - i * 20}m", "1Gi") for i in range(48)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def tail_inputs():
    pods = [jm._mkpod(f"p{i:03d}", f"{4000 - i * 50}m", "1Gi") for i in range(60)]
    pods2 = pods + [jm._mkpod(f"z{i}", f"{4000 - 59 * 50}m", "1Gi") for i in range(3)]
    return (SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES),
            SolverInput(pods=pods2, nodes=[], nodepools=[pool()], zones=ZONES))


def relax_input():
    tsc = TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL,
                                   label_selector={"app": "w"},
                                   when_unsatisfiable="ScheduleAnyway")
    pods = [mkpod(f"r{i:02d}", cpu="2", mem="4Gi", labels={"app": "w"}, topology_spread=[tsc])
            for i in range(12)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def zone_input():
    pods = _zone_fleet(9) + jm._random_fleet(random.Random(3), 40)
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def constrained_input():
    anti = PodAffinityTerm(label_selector={"app": "solo"}, topology_key=wk.ZONE_LABEL, anti=True)
    pods = (_zone_fleet(12)
            + [mkpod(f"a{i}", cpu="1", mem="2Gi", labels={"app": "solo"}, affinity_terms=[anti])
               for i in range(5)]
            + jm._random_fleet(random.Random(17), 50))
    return SolverInput(pods=pods, nodes=[mknode(f"n{i}", ZONES[i % 3]) for i in range(4)],
                       nodepools=[pool()], zones=ZONES)


def tiny_input():
    pods = [jm._mkpod(f"t{i}", "1", "1Gi") for i in range(6)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


# ------------------------------------------------------------ kernel level

KERNEL_FLEETS = {"fast": nodes_input, "zoned": constrained_input}


def _leaves_equal(j, t: dict, what):
    for k in ("take_e", "take_c", "leftover"):
        np.testing.assert_array_equal(np.asarray(getattr(j, k)), t[k], err_msg=f"{what} {k}")
    for k, v in t["state"].items():
        np.testing.assert_array_equal(np.asarray(getattr(j.state, k)), v, err_msg=f"{what} {k}")


@pytest.mark.parametrize("Nd", [2, 4, 8])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", sorted(KERNEL_FLEETS))
def test_plain_sharded_scan_matches_jax(kind, sparse, Nd):
    enc = jencode.encode(jencode.quantize_input(KERNEL_FLEETS[kind]()))
    zone = enc.V > 0
    assert zone == (kind == "zoned")
    host, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    rgb, rcb = jencode.mesh_run_blocks(host[0], host[1], Nd)
    trgb, trcb = tencode.mesh_run_blocks(host[0], host[1], Nd)
    np.testing.assert_array_equal(trgb, rgb)
    np.testing.assert_array_equal(trcb, rcb)
    sh = (rgb, rcb) + tuple(host[2:])
    M = 64
    Sblk = dims["Sp"] // Nd
    if sparse:
        rqi, rvi = jencode.sparse_run_tables(enc, dims["Sp"])
        sq, sv = rqi.reshape(Nd, Sblk, -1), rvi.reshape(Nd, Sblk, -1)
        j = jffd.ffd_solve_sharded_sparse(sq, sv, *sh, max_claims=M, zone_engine=zone)
        targs = args_to_torch((sq, sv) + sh, "cpu")
        t = tffd.ffd_solve_sharded_sparse(*targs, max_claims=M, zone_engine=zone)
    else:
        j = jffd.ffd_solve_sharded(*sh, max_claims=M, zone_engine=zone)
        targs = args_to_torch(sh, "cpu")
        t = tffd.ffd_solve_sharded(*targs, max_claims=M, zone_engine=zone)
    j = jax.tree_util.tree_map(np.asarray, j)
    assert tuple(t.take_e.shape[:2]) == (Nd, Sblk)
    _leaves_equal(j, output_to_numpy(t), f"{kind} Nd={Nd}")
    # each lane is the single-block scan from the initial carry
    shared = args_to_torch(host[2:], "cpu")
    for d in range(Nd):
        blk = (torch.from_numpy(rgb[d]), torch.from_numpy(rcb[d])) + shared
        if sparse:
            one = tffd.ffd_solve_sparse_plain(targs[0][d], targs[1][d], *blk, max_claims=M,
                                              zone_engine=zone)
        else:
            one = tffd.ffd_solve_plain(*blk, max_claims=M, zone_engine=zone)
        _leaves_equal(tffd.output_lane(t, d), output_to_numpy(one), f"lane {d}")


def test_mesh_run_blocks_refuses_a_misaligned_axis():
    with pytest.raises(tencode.UnpackableInput):
        tencode.mesh_run_blocks(np.zeros(16, np.int32), np.zeros(16, np.int32), 3)
    with pytest.raises(jencode.UnpackableInput):
        jencode.mesh_run_blocks(np.zeros(16, np.int32), np.zeros(16, np.int32), 3)


# ------------------------------------------------------------ solver level


def _assert_same(a, b, tag):
    jm._assert_same(a, b, tag)


def _solve_pair(jinp, n, jax_solver=None, port_solver=None):
    """(JAX result, port result, JAX solver, port solver) of one solve at
    shards=n, the port under virtual_devices(8)."""
    js = jax_solver or jbackend.TPUSolver(shards=n)
    ts = port_solver or TorchSolver(device="cpu", shards=n)
    jr = js.solve(jinp)
    with tsh.virtual_devices(8):
        tr = ts.solve(to_port(jinp))
    return jr, tr, js, ts


def _check_against_jax(jr, tr, js, ts, tag):
    _assert_same(tr, jr, tag)
    assert {k: ts.stats[k] for k in SHARD_STATS} == {k: js.stats[k] for k in SHARD_STATS}, (
        tag, ts.stats, js.stats)
    assert {k: ts.ledger.solve[k] for k in LEDGER_KEYS} == {
        k: js.ledger.solve[k] for k in LEDGER_KEYS}, (tag, ts.ledger.solve, js.ledger.solve)


@pytest.mark.parametrize("n", jm.MESH_SIZES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_fleets_decide_as_jax(seed, n):
    inp = random_input(seed)
    jr, tr, js, ts = _solve_pair(inp, n)
    _check_against_jax(jr, tr, js, ts, f"seed={seed} shards={n}")
    _assert_same(tr, TorchSolver(device="cpu").solve(to_port(inp)), "unsharded port")
    assert ts.stats["sharded_solves"] == (1 if n >= 2 else 0), ts.stats
    assert ts.stats["sharded_fallbacks"] == 0


@pytest.mark.parametrize("n", [2, 8])
def test_existing_nodes_decide_as_jax(n):
    jr, tr, js, ts = _solve_pair(nodes_input(), n)
    _check_against_jax(jr, tr, js, ts, f"nodes shards={n}")
    assert ts.stats["sharded_solves"] == 1


def test_fixup_replay_fires_as_in_jax():
    jr, tr, js, ts = _solve_pair(fixup_input(), 8)
    _check_against_jax(jr, tr, js, ts, "fixup")
    assert ts.stats["shard_fixup_runs"] > 0, ts.stats


def test_suffix_resume_composes_as_in_jax():
    inp1, inp2 = tail_inputs()
    js, ts = jbackend.TPUSolver(shards=8), TorchSolver(device="cpu", shards=8)
    for tag, inp in (("resume warm", inp1), ("resume tail", inp2)):
        jr, tr, _, _ = _solve_pair(inp, 8, js, ts)
        _check_against_jax(jr, tr, js, ts, tag)
        _assert_same(tr, TorchSolver(device="cpu").solve(to_port(inp)), tag)
    assert ts.stats["shard_resume_solves"] == 1 and ts.stats["shard_resume_runs_skipped"] > 0


def test_relax_fleet_decides_as_jax():
    jr, tr, js, ts = _solve_pair(relax_input(), 8)
    _check_against_jax(jr, tr, js, ts, "relax")


def test_zone_spread_fleet_shards_as_in_jax():
    jr, tr, js, ts = _solve_pair(zone_input(), 8)
    _check_against_jax(jr, tr, js, ts, "V-shard")
    assert ts.stats["sharded_solves"] == 1 and ts.stats["sharded_fallbacks"] == 0


@pytest.mark.parametrize("n", jm.MESH_SIZES)
def test_constrained_fleets_decide_as_jax(n):
    jr, tr, js, ts = _solve_pair(constrained_input(), n)
    _check_against_jax(jr, tr, js, ts, f"constrained shards={n}")
    if n >= 2:
        assert ts.stats["sharded_solves"] == 1 and ts.stats["sharded_fallbacks"] == 0
        assert ts.stats["sparse_dispatches"] == js.stats["sparse_dispatches"]


def test_tiny_fleet_declines_as_in_jax():
    jr, tr, js, ts = _solve_pair(tiny_input(), 8)
    _check_against_jax(jr, tr, js, ts, "tiny")
    assert ts.stats["sharded_fallbacks"] >= 1 and ts.stats["sharded_solves"] == 0


def test_shards_off_never_touches_the_mesh_path():
    s = TorchSolver(device="cpu")
    with tsh.virtual_devices(8):
        s.solve(to_port(SolverInput(pods=jm._random_fleet(random.Random(11), 40), nodes=[],
                                    nodepools=[pool()], zones=ZONES)))
        assert s._shard_mesh() is None
    assert s.stats["sharded_solves"] == 0 and s.stats["sharded_fallbacks"] == 0


def test_leaving_the_virtual_mesh_restores_the_single_device_path():
    """The mesh caches key on the slot list: outside virtual_devices the CPU
    has one slot, so the same solver takes the single-device path (not
    counted as a decline) and its residency keys differ from the sharded
    solve's."""
    s = TorchSolver(device="cpu", shards=8)
    inp = to_port(random_input(0))
    with tsh.virtual_devices(8):
        a = s.solve(inp)
        assert s._shard_mesh().size == 8
    assert s._shard_mesh() is None
    b = s.solve(inp)
    _assert_same(a, b, "after leaving")
    assert s.stats["sharded_solves"] == 1 and s.stats["sharded_fallbacks"] == 0
    assert len(s.arena._buckets) == 2  # the mesh token is part of the bucket key


def test_cohort_members_ride_solo_when_sharded():
    s = TorchSolver(device="cpu", shards=8)
    with tsh.virtual_devices(8):
        assert s._cohort_prep(to_port(random_input(0))) is None


def test_sharded_claim_overflow_raises_as_the_unsharded_path():
    from karpenter_tpu_torch.solver.backend import UnsupportedInput

    # 16 runs of big pods, more than 64 claims: past max_claims=64 (the
    # reference hands such a solve to its fallback chain)
    pods = [jm._mkpod(f"b{i:03d}", f"{45000 + (i % 16) * 500}m", "1Gi") for i in range(300)]
    inp = to_port(SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES))
    s = TorchSolver(device="cpu", shards=8, max_claims=64)
    with tsh.virtual_devices(8):
        with pytest.raises(UnsupportedInput, match="max_claims"):
            s.solve(inp)
    assert s.stats["sharded_solves"] == 0 and s.stats["sharded_fallbacks"] == 0
    with pytest.raises(UnsupportedInput, match="max_claims"):
        TorchSolver(device="cpu", max_claims=64).solve(inp)


# ------------------------------------------------------------------ arena


def test_failed_dispatch_invalidation_drops_shard_residency(monkeypatch):
    """tests/test_transfer_arena.py's sharded invalidation scenario: after a
    failed sharded dispatch, invalidate_arena() (what the reference's
    resilience layer calls before its replay) drops the per-slot argument
    residency AND the block-boundary carries; the recovered solve
    re-establishes both, uploads as a cold JAX sharded solve does, and
    decides as before."""
    jinp = _inp(40, specs=20)
    inp = to_port(jinp)
    s = TorchSolver(device="cpu", shards=8)
    with tsh.virtual_devices(8):
        warm = s.solve(inp)
        assert s.stats["sharded_solves"] >= 1 and s.arena._shards and s.arena._buckets

        def failed(*a, **k):
            raise RuntimeError("device dispatch failed")

        with monkeypatch.context() as m:
            m.setattr(tsh, "mesh_solve", failed)
            with pytest.raises(RuntimeError, match="dispatch failed"):
                s.solve(to_port(_inp(40, specs=20, prefix="q")))
        s.invalidate_arena()
        assert s.arena.stats["invalidations"] >= 1
        assert not s.arena._shards and not s.arena._buckets
        recovered = s.solve(inp)
    _assert_same(recovered, warm, "sharded invalidation replay")
    assert s.arena._shards and s.arena._buckets
    j = jbackend.TPUSolver(shards=8)
    j.solve(jinp)
    j.invalidate_arena()
    j.solve(jinp)
    assert {k: s.ledger.solve[k] for k in LEDGER_KEYS} == {k: j.ledger.solve[k] for k in LEDGER_KEYS}


# ---------------------------------------------------------- consolidation


def _consolidation_case(scenario):
    kind, seed = {"replicated": ("fast", 0), "heterogeneous": ("fast", 1),
                  "mixed_axis": ("mixed", 0)}[scenario]
    f = fleet(seed, kind)
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    n_cand = len(f["cand_node"])
    if scenario == "replicated":
        subs = [list(range(n_cand - 1))] * 8  # identical rows
    else:
        subs = subsets_for(n_cand, seed + 3)
    return enc, args, pod_cand, pod_run, node_idx, v_delta, subs


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("scenario", ["replicated", "heterogeneous", "mixed_axis"])
def test_simulate_subsets_on_a_virtual_mesh_matches_jax(scenario, n):
    enc, args, pod_cand, pod_run, node_idx, v_delta, subs = _consolidation_case(scenario)
    zone = enc.V > 0
    assert zone == (scenario == "mixed_axis")
    j = jcons.simulate_subsets(args, pod_cand, pod_run, subs, node_idx, 16,
                               candidate_v_delta=v_delta, verdict_only=True, zone_engine=zone,
                               v_count0_host=args[jcons._V_COUNT0])
    assert jcons.candidate_mesh() is not None and jcons.candidate_mesh().devices.size == 8
    with tsh.virtual_devices(n):
        mesh = tcons.candidate_mesh("cpu")
        assert mesh is not None and mesh.size == n
        t = tcons.simulate_subsets(args_to_torch(args, "cpu"), pod_cand, pod_run, subs, node_idx,
                                   16, candidate_v_delta=v_delta, zone_engine=zone,
                                   v_count0_host=args[tcons._V_COUNT0])
    assert tcons.candidate_mesh("cpu") is None
    assert_outputs_equal(j, t)
    if scenario == "replicated":
        used = np.asarray(j.state.used)
        assert (used[: len(subs)] == used[0]).all()


@pytest.mark.parametrize("name", ["zone_anti_accept", "mixed_axis_open"])
def test_evaluator_on_a_candidate_mesh_matches_jax(name):
    """The evaluator adopts its universe under the universe placement (one
    packed message, the bytes the JAX evaluator uploads on its 8-device
    mesh), a re-prepare is an exact hit, and the verdicts equal the JAX
    evaluator's and the port's without a mesh."""
    u, subsets = FLEETS[name]
    jsolver = jbackend.TPUSolver()
    jev = jbatched.BatchedConsolidationEvaluator(jsolver)
    jbase, jpods, jnode = materialize(u, "karpenter_tpu")
    jsolver.ledger.begin_solve()
    jprep = jev.prepare(jbase, jpods, jnode)
    jled = dict(jsolver.ledger.solve)
    jv = jev.evaluate_prepared(jprep, subsets)
    tbase, tpods, tnode = materialize(u, "karpenter_tpu_torch")
    plain = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
    want = plain.evaluate_prepared(plain.prepare(tbase, tpods, tnode), subsets)
    s = TorchSolver(device="cpu")
    ev = tbatched.BatchedConsolidationEvaluator(s)
    with tsh.virtual_devices(8):
        s.ledger.begin_solve()
        prep = ev.prepare(tbase, tpods, tnode)
        led = dict(s.ledger.solve)
        tv = ev.evaluate_prepared(prep, subsets)
        ev.prepare(tbase, tpods, tnode)
        placement = tcons.universe_sharding("cpu")
    assert all(k[1] == placement for k in s.arena._buckets)
    assert s.arena.stats["exact_hits"] == 1
    assert {k: led[k] for k in LEDGER_KEYS} == {k: jled[k] for k in LEDGER_KEYS}
    key = lambda v: (v.ok, v.has_replacement, v.replacement_price, v.replacement_type_count)  # noqa: E731
    assert [key(v) for v in tv] == [key(v) for v in jv] == [key(v) for v in want]


def test_evaluator_without_the_arena_on_a_candidate_mesh():
    """arena=False: prepare copies the universe to every physical device of
    the candidate mesh (replicate_shared) and the verdicts stay those of
    the evaluator without a mesh."""
    u, subsets = FLEETS["zone_anti_accept"]
    tbase, tpods, tnode = materialize(u, "karpenter_tpu_torch")
    plain = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu", arena=False))
    want = plain.evaluate_prepared(plain.prepare(tbase, tpods, tnode), subsets)
    ev = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu", arena=False))
    with tsh.virtual_devices(4):
        prep = ev.prepare(tbase, tpods, tnode)
        assert all(isinstance(a, tuple) and len(a) == 1 for a in prep.args)
        got = ev.evaluate_prepared(prep, subsets)
    key = lambda v: (v.ok, v.has_replacement, v.replacement_price, v.replacement_type_count)  # noqa: E731
    assert [key(v) for v in got] == [key(v) for v in want]


# ------------------------------------------------------------------- mesh


def test_virtual_slots_deal_round_robin():
    assert tsh.device_slots("cpu") == (torch.device("cpu"),)
    with tsh.virtual_devices(8):
        assert tsh.device_slots("cpu") == (torch.device("cpu"),) * 8
        with tsh.virtual_devices(3):
            assert len(tsh.device_slots("cpu")) == 3
        assert len(tsh.device_slots("cpu")) == 8
        m = tsh.make_mesh(4, "shards", device="cpu")
        assert m.size == 4 and m.physical == (torch.device("cpu"),)
    assert tsh.device_slots("cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        with tsh.virtual_devices(0):
            pass


def test_candidate_rows_split_per_physical_device():
    """A mesh dealt over two devices (constructed, never launched on): each
    device holds its slots' rows in slot order, and the split covers every
    row once."""
    m = tsh.Mesh(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "candidates")
    assert m.physical == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert m.local_slots(0) == [0, 2] and m.local_slots(1) == [1, 3]
    rows = tsh.slot_rows(m, 8)
    assert [r.tolist() for r in rows] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert sorted(np.concatenate(rows).tolist()) == list(range(8))
    assert tsh.batch_bucket(9, m) == 16 and tsh.batch_bucket(9, 3) == 24
    assert tsh.batch_bucket(9, None) == 16
    assert m == tsh.Mesh(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "candidates")
    assert hash(tsh.Placement(m, True)) == hash(tsh.Placement(tsh.Mesh(m.devices, m.axis), True))


def test_gather_lanes_puts_slots_in_order():
    """gather_lanes on a mesh of two CPU placeholders standing for two
    devices: lanes come back in slot order whichever device held them."""
    m = tsh.Mesh(["cpu", "cpu"], "shards")
    out = tffd.FFDOutput(
        take_e=torch.arange(2 * 3 * 2, dtype=torch.int32).reshape(2, 3, 2),
        take_c=torch.zeros((2, 3, 4), dtype=torch.int32),
        leftover=torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
        state=tffd.FFDState(*(torch.full((2, 1), i, dtype=torch.int32) for i in range(16))),
        events=torch.tensor([7, 8], dtype=torch.int32))
    h = tsh.gather_lanes(m, [(0, out)])
    np.testing.assert_array_equal(h.leftover, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(h.events, [7, 8])
