"""The port's scheduling classes (karpenter_tpu_torch/solver/scheduling_class.py)
against the JAX package's, on the CPU.

- The planner: the port's plain gang_commit / preemption_plan
  (solver/cuda/ffd.py, the plain versions K10/K11 are held to on the card)
  and its three legs against the JAX ffd.gang_commit / preemption_plan
  (jitted on the CPU), on seeded tables and on the edges: sums that wrap
  int32, every victim ineligible, gangs at or past NG, min_ranks 0, a free
  fit, no eligible node.
- The solve seam: ClassAwareSolver(TorchSolver(device="cpu")) against JAX
  ClassAwareSolver(TPUSolver()) and ClassAwareSolver(ReferenceSolver()) on
  quantize_input: placements, error keys, claims, evictions,
  gangs_unschedulable and class_stats, on the JAX tests' own fleets
  (tests/test_scheduling_class.py; each reused test is named in a comment)
  converted to the port's classes.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from karpenter_tpu.api import wellknown as jwk
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import scheduling_class as jsc
from karpenter_tpu.solver.backend import ReferenceSolver, TPUSolver
from karpenter_tpu.solver.encode import quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import scheduling_class as tsc
from karpenter_tpu_torch.solver.backend import TorchSolver, concrete_backend
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_scheduling_class import (
    ZONES,
    _random_fleet,
    gang_labels,
    mknode,
    mkpod,
    pool,
    victim,
)
from tests.test_torch_relax import to_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _class_knobs():
    """Both packages start and end with the default-on knobs."""
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)
    yield
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)


# ---------------------------------------------------------------------------
# Planner parity
# ---------------------------------------------------------------------------


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _gang_tables(rng, wrap=False, past_ng=False):
    ng = int(rng.integers(1, 6))
    s = int(rng.integers(0, 40))
    hi = 2**31 - 1 if wrap else 3
    run_placed = rng.integers(0 if not wrap else 2**30, hi, s).astype(np.int32)
    run_gang = rng.integers(-2, ng + (3 if past_ng else 0), s).astype(np.int32)
    gang_size = rng.integers(1, 6, ng).astype(np.int32)
    gang_min_ranks = rng.integers(0, 6, ng).astype(np.int32)
    return run_placed, run_gang, gang_size, gang_min_ranks


def _gang_legs(tables, oracle_too=True):
    """JAX, the plain version and every port leg on `tables`."""
    want = [np.asarray(x) for x in jffd.gang_commit(*tables)]
    got = {"plain": [x.numpy() for x in tffd.gang_commit_plain(*_t(*tables))],
           "device": tsc.PLANNERS["device"][0](*tables, device="cpu")}
    if oracle_too:
        got["oracle"] = tsc.PLANNERS["oracle"][0](*[a.tolist() for a in tables])
        got["host"] = tsc.PLANNERS["host"][0](*tables)
    for name, (commit, placed) in got.items():
        assert np.array_equal(np.asarray(commit), want[0]), name
        assert np.array_equal(np.asarray(placed), want[1]), name
    return want


@pytest.mark.parametrize("seed", range(4))
def test_gang_commit_legs_randomized(seed):
    # tests/test_scheduling_class.py test_gang_commit_three_legs_randomized
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        _gang_legs(_gang_tables(rng))


def test_gang_commit_wrap_and_past_ng():
    """Sums past 2**31 wrap as XLA's int32 does (the host mirror's int32
    accumulator too; the oracle's unbounded ints do not, so it sits out),
    and gangs at or past NG count nowhere."""
    rng = np.random.default_rng(7)
    wrapped = past = 0
    for _ in range(20):
        t = _gang_tables(rng, wrap=True)
        want = _gang_legs(t, oracle_too=False)
        wrapped += int((want[1] < 0).any())
        t = _gang_tables(rng, past_ng=True)
        _gang_legs(t, oracle_too=False)
        past += int((t[1] >= len(t[2])).any())
    assert wrapped and past
    # min_ranks 0 never commits, even with members placed
    commit, placed = tffd.gang_commit_plain(*_t(np.ones(3, np.int32), np.zeros(3, np.int32),
                                               np.ones(1, np.int32), np.zeros(1, np.int32)))
    assert int(placed[0]) == 3 and not bool(commit[0])


def _plan_tables(rng, big=False, none_ok=False):
    E, Vm, R = int(rng.integers(1, 7)), int(rng.integers(1, 40)), int(rng.integers(1, 4))
    node_free = rng.integers(0, 2**30 if big else 5, (E, R)).astype(np.int32)
    victim_prio = rng.integers(0, 6, (E, Vm)).astype(np.int32)
    victim_req = rng.integers(0, 2**30 if big else 4, (E, Vm, R)).astype(np.int32)
    victim_ok = rng.random((E, Vm)) < (0.0 if none_ok else 0.7)
    node_ok = rng.random(E) < 0.8
    need = rng.integers(1, 2**31 - 1 if big else 7, R).astype(np.int32)
    return node_free, victim_prio, victim_req, victim_ok, node_ok, need, int(rng.integers(0, 7))


def _plan_legs(tables, oracle_too=True):
    *arrays, pod_prio = tables
    je, jt = jffd.preemption_plan(*arrays, np.int32(pod_prio))
    want = (int(je), np.asarray(jt))
    pe, pt = tffd.preemption_plan_plain(*_t(*arrays), pod_prio)
    got = {"plain": (int(pe), pt.numpy()),
           "device": tsc.PLANNERS["device"][1](*arrays, pod_prio, device="cpu")}
    if oracle_too:
        got["oracle"] = tsc.PLANNERS["oracle"][1](*[a.tolist() for a in arrays], pod_prio)
        got["host"] = tsc.PLANNERS["host"][1](*arrays, pod_prio)
    for name, (e, mask) in got.items():
        assert int(e) == want[0], (name, e, want[0])
        assert np.array_equal(np.asarray(mask), want[1]), name
    return want


@pytest.mark.parametrize("seed", range(4))
def test_preemption_plan_legs_randomized(seed):
    # tests/test_scheduling_class.py test_preemption_plan_three_legs_randomized
    rng = np.random.default_rng(200 + seed)
    hits = 0
    for _ in range(20):
        e, mask = _plan_legs(_plan_tables(rng))
        hits += int(mask.any())
    assert hits


def test_preemption_plan_wrap_and_ineligible():
    """int32 sums that wrap (the device legs follow XLA; the int64 host
    mirror and the oracle differ there by design, so they sit out), and
    every victim ineligible: only a free fit can plan, with an empty mask."""
    rng = np.random.default_rng(11)
    for _ in range(20):
        _plan_legs(_plan_tables(rng, big=True), oracle_too=False)
    for _ in range(20):
        e, mask = _plan_legs(_plan_tables(rng, none_ok=True))
        assert not mask.any()


def test_preemption_plan_edges():
    # tests/test_scheduling_class.py test_preemption_plan_free_fit_needs_no_eviction
    # and test_preemption_plan_no_eligible_node, on every port leg
    for name, (_gc, plan) in tsc.PLANNERS.items():
        kw = {"device": "cpu"} if name == "device" else {}
        args = [np.asarray(a) for a in ([[5, 5]], [[0]], [[[1, 1]]], [[True]], [True], [2, 2])]
        e, mask = plan(*args, 9, **kw)
        assert int(e) == 0 and not np.asarray(mask).any(), name
        args[0], args[4] = np.asarray([[0, 0]]), np.asarray([False])
        e, mask = plan(*args, 9, **kw)
        assert int(e) == -1 and not np.asarray(mask).any(), name
    # Vm = 1, E = 1: the only victim covers the need
    t = (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32), np.ones((1, 1, 1), np.int32),
         np.ones((1, 1), bool), np.ones(1, bool), np.ones(1, np.int32), 5)
    e, mask = _plan_legs(t)
    assert e == 0 and mask.tolist() == [[True]]


def test_eviction_wire_pinned():
    rows = [(0, 1), (3, 2), (65535, 7)]
    assert np.array_equal(tffd.pack_evictions(rows), jffd.pack_evictions(rows))
    assert tffd.unpack_evictions(tffd.pack_evictions(rows)) == (False, rows)
    over = [(65536, 0)]
    assert np.array_equal(tffd.pack_evictions(over), jffd.pack_evictions(over))
    assert tffd.unpack_evictions(tffd.pack_evictions(over)) == (True, [])


def test_select_planner_and_device():
    # tests/test_scheduling_class.py test_select_planner
    s = TorchSolver(device="cpu")
    caw = tsc.ClassAwareSolver(s)
    assert tsc.select_planner(s) == tsc.select_planner(caw) == "device"
    assert concrete_backend(tsc.ClassAwareSolver(caw)) is s
    assert tsc.select_planner(object()) == "oracle"
    # the device leg runs on the concrete backend's device
    gang_fn, plan_fn = caw._planners()
    assert gang_fn.keywords == plan_fn.keywords == {"device": s.device}


# ---------------------------------------------------------------------------
# The solve seam: the port against both JAX legs
# ---------------------------------------------------------------------------


def _claims_sig(res):
    return [(c.nodepool, sorted(c.instance_type_names), list(c.pod_uids)) for c in res.claims]


def _evictions(res):
    return [(e.node_id, e.pod_uid, e.victim_priority, e.for_pod) for e in res.evictions]


def assert_class_parity(inp: SolverInput, solver=None):
    """The port's class wrapper over TorchSolver(device="cpu") decides as
    the JAX wrapper over TPUSolver and over ReferenceSolver, and counts the
    same class events."""
    legs = {
        "oracle": jsc.ClassAwareSolver(ReferenceSolver()),
        "tpu": jsc.ClassAwareSolver(TPUSolver()),
    }
    got_caw = tsc.ClassAwareSolver(solver if solver is not None else TorchSolver(device="cpu"))
    got = got_caw.solve(to_port(inp))
    for name, caw in legs.items():
        want = caw.solve(quantize_input(inp) if name == "oracle" else inp)
        assert got.placements == want.placements, f"{name}: placements diverge"
        assert set(got.errors) == set(want.errors), f"{name}: error keys diverge"
        assert _claims_sig(got) == _claims_sig(want), f"{name}: claims diverge"
        assert _evictions(got) == _evictions(want), f"{name}: evictions diverge"
        assert got.gangs_unschedulable == want.gangs_unschedulable, f"{name}: gang verdicts"
        assert got_caw.class_stats == caw.class_stats, (name, got_caw.class_stats,
                                                        caw.class_stats)
    assert got_caw.class_stats["priority_inversions"] == 0
    return got, got_caw


@pytest.mark.parametrize("seed", range(8))
def test_random_fleet_parity(seed):
    # tests/test_scheduling_class.py test_randomized_mixed_fleets
    assert_class_parity(_random_fleet(seed))


def test_preemption_contention_parity():
    # tests/test_scheduling_class.py test_preemption_contention_parity
    nodes = [
        mknode(f"n{e}", cpu="0", mem="0Mi", victims=[
            victim(f"v-{e}-{v}", priority=v, cpu="1", mem="1Gi") for v in range(3)
        ])
        for e in range(3)
    ]
    pods = [mkpod(f"hi{i}", cpu="1", mem="1Gi", priority=100) for i in range(6)]
    res, caw = assert_class_parity(SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES))
    assert res.evictions and caw.class_stats["preemptions"] == len(res.evictions)


def test_gang_and_preemption_together_parity():
    # tests/test_scheduling_class.py test_gang_and_preemption_together_parity
    nodes = [mknode(f"n{e}", cpu="2", mem="4Gi", victims=[victim(f"v-{e}", priority=0, cpu="1")])
             for e in range(2)]
    pods = [mkpod(f"g{r}", cpu="1", labels=gang_labels("job", 3), priority=50) for r in range(3)]
    pods += [mkpod(f"hi{i}", cpu="2", mem="2Gi", priority=100) for i in range(3)]
    assert_class_parity(SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES))


def test_gang_rollback_parity():
    # tests/test_scheduling_class.py test_gang_rollback_strips_every_member
    node = mknode("n0", cpu="2", mem="4Gi")
    pods = [mkpod(f"g{i}", cpu="1", labels=gang_labels("job", 3), priority=50) for i in range(3)]
    pods.append(mkpod("single", cpu="1", priority=0))
    res, caw = assert_class_parity(SolverInput(pods=pods, nodes=[node], nodepools=[], zones=ZONES))
    assert res.gangs_unschedulable == ["job"] and res.placements["single"] == ("node", "n0")
    assert caw.class_stats["gang_rounds"] == 1


def test_min_ranks_partial_commit_parity():
    # tests/test_scheduling_class.py test_min_ranks_partial_commit
    node = mknode("n0", cpu="2", mem="4Gi")
    pods = [mkpod(f"g{i}", cpu="1", labels=gang_labels("job", 3, min_ranks=2)) for i in range(3)]
    res, caw = assert_class_parity(SolverInput(pods=pods, nodes=[node], nodepools=[], zones=ZONES))
    assert res.gangs_unschedulable == [] and caw.class_stats["gangs_placed"] == 1


def test_oversized_gang_parity(monkeypatch):
    # tests/test_scheduling_class.py test_oversized_gang_declines_and_strips
    monkeypatch.setattr(jsc, "GANG_CLAIM_BUDGET", 2)
    monkeypatch.setattr(tsc, "GANG_CLAIM_BUDGET", 2)
    pods = [mkpod(f"g{i}", cpu="100m", labels=gang_labels("big", 3)) for i in range(3)]
    pods.append(mkpod("single", cpu="100m"))
    res, caw = assert_class_parity(SolverInput(pods=pods, nodes=[], nodepools=[pool()],
                                               zones=ZONES))
    assert res.gangs_unschedulable == ["big"] and "single" in res.placements
    assert caw.class_stats["declines"] == 1


def test_malformed_gang_labels_parity():
    # tests/test_scheduling_class.py test_malformed_gang_labels_void_gang
    labels = {jwk.GANG_LABEL: "job", jwk.GANG_SIZE_LABEL: "banana"}
    res, caw = assert_class_parity(SolverInput(pods=[mkpod("p", labels=labels)], nodes=[],
                                               nodepools=[pool()], zones=ZONES))
    assert caw.class_stats["class_solves"] == 0 and "p" in res.placements


def test_minimal_prefix_parity():
    # tests/test_scheduling_class.py test_minimal_prefix_lowest_priority_first
    node = mknode("n0", cpu="0", mem="0Mi", victims=[
        victim("v-c", priority=3), victim("v-a", priority=1), victim("v-b", priority=2)])
    res, _ = assert_class_parity(SolverInput(pods=[mkpod("hi", cpu="2", mem="2Gi", priority=100)],
                                             nodes=[node], nodepools=[], zones=ZONES))
    assert [(e.pod_uid, e.victim_priority) for e in res.evictions] == [("v-a", 1), ("v-b", 2)]


def test_unevictable_victims_parity():
    # tests/test_scheduling_class.py test_unevictable_victims_are_skipped
    n0 = mknode("n0", cpu="0", mem="0Mi", victims=[victim("v-pinned", evictable=False)])
    n1 = mknode("n1", cpu="0", mem="0Mi", victims=[victim("v-free")])
    res, _ = assert_class_parity(SolverInput(pods=[mkpod("hi", cpu="1", priority=100)],
                                             nodes=[n0, n1], nodepools=[], zones=ZONES))
    assert _evictions(res) == [("n1", "v-free", 0, "hi")]


def test_topology_decline_parity():
    # tests/test_scheduling_class.py test_topology_interaction_declines_counted:
    # the injected gang affinity sends the inner solve through the relax
    # ladder and the preemption pass declines
    node = mknode("n0", cpu="2", mem="4Gi", victims=[victim("v", priority=0)])
    pods = [mkpod(f"g{i}", cpu="1", priority=100,
                  labels=gang_labels("job", 2, topology=jwk.ZONE_LABEL)) for i in range(2)]
    pods.append(mkpod("hi", cpu="1", priority=50))
    s = TorchSolver(device="cpu")
    res, caw = assert_class_parity(SolverInput(pods=pods, nodes=[node], nodepools=[],
                                               zones=ZONES), solver=s)
    assert res.evictions == [] and caw.class_stats["declines"] >= 1
    assert s.stats["ladder_solves"] >= 1


def test_eviction_budget_parity(monkeypatch):
    # tests/test_scheduling_class.py test_eviction_budget_declines_counted
    monkeypatch.setattr(jsc, "MAX_EVICTIONS_PER_SOLVE", 0)
    monkeypatch.setattr(tsc, "MAX_EVICTIONS_PER_SOLVE", 0)
    node = mknode("n0", cpu="0", mem="0Mi", victims=[victim("v", priority=0)])
    res, caw = assert_class_parity(SolverInput(pods=[mkpod("hi", cpu="1", priority=100)],
                                               nodes=[node], nodepools=[], zones=ZONES))
    assert res.evictions == [] and caw.class_stats["declines"] == 1


def test_charged_free_table_parity():
    # tests/test_scheduling_class.py test_free_tables_charged_with_own_placements
    node = mknode("n0", cpu="1", mem="2Gi", victims=[victim("v", priority=0)])
    pods = [mkpod("hi-a", cpu="1", priority=100), mkpod("hi-b", cpu="1", priority=100)]
    res, _ = assert_class_parity(SolverInput(pods=pods, nodes=[node], nodepools=[], zones=ZONES))
    assert [e.pod_uid for e in res.evictions] == ["v"]


def test_knobs_off_parity():
    # tests/test_scheduling_class.py test_knobs_off_inert_with_classes_present
    for m in (jsc, tsc):
        m.configure(preemption=False, gang=False)
    pods = [mkpod("hi", priority=100), mkpod("g0", labels=gang_labels("job", 2)),
            mkpod("g1", labels=gang_labels("job", 2))]
    nodes = [mknode("n0", cpu="0", mem="0Mi", victims=[victim("v0", 0)])]
    inp = SolverInput(pods=pods, nodes=nodes, nodepools=[pool()], zones=ZONES)
    res, caw = assert_class_parity(inp)
    assert caw.class_stats["class_solves"] == 0 and res.evictions == []
    assert res.placements == TorchSolver(device="cpu").solve(to_port(inp)).placements


def test_flat_fleet_delegates_verbatim():
    # tests/test_scheduling_class.py test_tpu_flat_delegation_bit_identical
    pods = [mkpod(f"p{i}", cpu="500m") for i in range(8)]
    inp = to_port(SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES))
    caw = tsc.ClassAwareSolver(TorchSolver(device="cpu"))
    got = caw.solve(inp)
    assert caw.class_stats["class_solves"] == 0
    assert got.placements == TorchSolver(device="cpu").solve(inp).placements
    assert caw.stats is caw.inner.stats and caw.stats["device_solves"] == 1
    assert caw.solve_async(inp).result().placements == got.placements


@pytest.mark.parametrize("variant", ["no_resume_no_ladder", "dense_pack", "sparse_off"])
def test_torch_variants_decision_identical(variant):
    # tests/test_scheduling_class.py test_tpu_variants_decision_identical
    kw = {"no_resume_no_ladder": dict(resume=False, relax_ladder=False),
          "dense_pack": dict(device_decode=False), "sparse_off": dict(sparse="off")}[variant]
    assert_class_parity(_random_fleet(42), solver=TorchSolver(device="cpu", **kw))


def test_class_fleet_parity():
    """chip_smoke.py's class_contended fleet, cut to 40 nodes: one gang round
    strips the doomed gang, the gangs commit, the singleton tail preempts."""
    import bench

    inp = bench._gang_input(n_nodes=40, victims_per_node=8, n_high=120, n_gangs=20, gang_size=8)
    before = dict(tsc.PLANNER_TRANSFER)
    res, caw = assert_class_parity(inp)
    st = caw.class_stats
    assert (st["gang_rounds"], st["gangs_placed"], st["gangs_unschedulable"]) == (1, 20, 1)
    assert st["preemptions"] == len(res.evictions) > 0
    assert tsc.PLANNER_TRANSFER["gang_calls"] - before["gang_calls"] == 2
    assert tsc.PLANNER_TRANSFER["plan_calls"] > before["plan_calls"]


def test_class_zone_parity():
    """The class fleet with every gang labelled for zone co-location: the
    inner solve takes the relax ladder and preemption declines
    (chip_smoke.py's class_zone cell, cut to 16 nodes)."""
    import bench

    inp = bench._gang_input(n_nodes=16, victims_per_node=4, n_high=40, n_gangs=6, gang_size=4)
    for p in inp.pods:
        if jwk.GANG_LABEL in p.meta.labels:
            p.meta.labels[jwk.GANG_TOPOLOGY_LABEL] = jwk.ZONE_LABEL
    s = TorchSolver(device="cpu")
    res, caw = assert_class_parity(inp, solver=s)
    assert res.evictions == [] and caw.class_stats["declines"] == 1
    assert s.stats["ladder_solves"] >= 1


def test_class_zone_past_128_gangs_parity(monkeypatch):
    """More zone-labelled gangs than the zoned scan once held in its static
    V rows (128): each gang's injected self-affinity is one zone sig, so
    V > 128, which now sizes the kernel's shared rows at launch. The port
    solves it through the relax ladder and decides as the JAX wrapper over
    the oracle (ClassAwareSolver(ReferenceSolver())). The JAX wrapper over
    TPUSolver is not a leg here: XLA's CPU compiler runs out of memory
    compiling its relax ladder at V > 128 (LLVM "Cannot allocate memory",
    then a segfault). chip_smoke.py runs class_zone at bench.py's 1 000
    gangs on the card."""
    import bench
    from karpenter_tpu_torch.solver import backend as tbackend

    inp = bench._gang_input(n_nodes=64, victims_per_node=1, n_high=4, n_gangs=130, gang_size=2)
    for p in inp.pods:
        if jwk.GANG_LABEL in p.meta.labels:
            p.meta.labels[jwk.GANG_TOPOLOGY_LABEL] = jwk.ZONE_LABEL
    seen_vp = []
    limits = tbackend.check_kernel_limits

    def recording(dims, host_args, zone, device):
        seen_vp.append(dims["Vp"] if zone else 0)
        return limits(dims, host_args, zone, device)

    monkeypatch.setattr(tbackend, "check_kernel_limits", recording)
    s = TorchSolver(device="cpu")
    got_caw = tsc.ClassAwareSolver(s)
    got = got_caw.solve(to_port(inp))
    caw = jsc.ClassAwareSolver(ReferenceSolver())
    want = caw.solve(quantize_input(inp))
    assert got.placements == want.placements
    assert set(got.errors) == set(want.errors)
    assert _claims_sig(got) == _claims_sig(want)
    assert _evictions(got) == _evictions(want) == []
    assert got.gangs_unschedulable == want.gangs_unschedulable
    assert got_caw.class_stats == caw.class_stats
    assert s.stats["ladder_solves"] >= 1 and max(seen_vp) > 128


def test_inject_gang_affinity_matches():
    pods = [mkpod("a", labels=gang_labels("g", 2, topology=jwk.ZONE_LABEL)),
            mkpod("b", labels=gang_labels("g", 2, topology="bogus")), mkpod("c")]
    want = jsc._inject_gang_affinity(pods)
    got = tsc._inject_gang_affinity(to_port(pods))
    assert got == to_port(want) and len(got[0].affinity_terms) == 1
    plain = to_port([mkpod("x"), mkpod("y")])
    assert tsc._inject_gang_affinity(plain) is plain


def test_deferred_seam_runs_the_class_path():
    rng = random.Random(5)
    nodes = [mknode("n0", cpu="0", mem="0Mi", victims=[victim("v", priority=0)])]
    pods = [mkpod(f"hi{i}", cpu=rng.choice(["500m", "1"]), priority=100) for i in range(3)]
    inp = to_port(SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES))
    caw = tsc.ClassAwareSolver(TorchSolver(device="cpu"))
    h = caw.solve_async(inp)
    assert caw.class_stats["class_solves"] == 0  # deferred until result()
    res = h.result()
    assert caw.class_stats["class_solves"] == 1
    assert _evictions(res) == _evictions(
        tsc.ClassAwareSolver(TorchSolver(device="cpu")).solve(dataclasses.replace(inp)))
