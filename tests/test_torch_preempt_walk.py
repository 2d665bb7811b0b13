"""The port's preemption walk (karpenter_tpu_torch/solver/cuda/ffd.py
preemption_walk_plain, the plain version the walk kernel is held to on the
card) and the class pass around it, on the CPU.

- The walk: preemption_walk_plain against a loop written here that calls
  the JAX package's ffd.preemption_plan once a candidate and applies the
  JAX class pass's updates (karpenter_tpu/solver/scheduling_class.py:585-606),
  exactly: the eviction rows, their count, the budget flag and the final
  free / victim_ok tables. The port's other legs (the device leg on the CPU,
  the host mirror, the python oracle) give the same rows and flag. Seeded
  tables (E 1-64, Vm 1-8, R 1-5, 1-40 candidates, 1-4 node rows) and the
  edges: a budget of 0, a budget crossed inside one
  candidate, free-alone fits (no charge), all-false node rows, int32 wrap of
  free + reclaim, victims at the candidate's own priority.
- The keyed node rows (scheduling_class.node_ok_table) against node_ok_mask
  for every candidate, on fleets with node selectors, required node
  affinity, tolerations, taints and unschedulable nodes.
- The walk in chunks (scheduling_class.walk_in_chunks) against one walk,
  and class solves whose candidates carry distinct keys, walked in chunks,
  against both JAX legs: node rows only for the chunks walked.
- A class solve whose eviction budget is crossed inside one candidate,
  against both JAX legs, and the device leg's transfer: one walk call a
  class solve whose candidates share their node rows, its tables uploaded
  once.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.api.objects import Taint, Toleration
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.scheduling.requirements import IN, NOT_IN, Requirement, Requirements
from karpenter_tpu.solver import scheduling_class as jsc
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import scheduling_class as tsc
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_scheduling_class import ZONES, mknode, mkpod, victim
from tests.test_torch_class import _evictions, assert_class_parity
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import to_port

torch.set_num_threads(1)

BIG = 2**30


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """The JAX plan compiles once per table shape: drop those programs when
    the module ends, so a worker's later modules do not inherit their
    memory maps."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _class_knobs():
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)
    yield
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)


# ---------------------------------------------------------------------------
# The walk against the JAX plan, one candidate at a time
# ---------------------------------------------------------------------------


def jax_walk(node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need, prio, budget):
    """The JAX class pass's loop over its device plan: (rows, flag, final
    node_free, final victim_ok)."""
    node_free, victim_ok = node_free.copy(), victim_ok.copy()
    rows, flag = [], False
    for c in range(len(cand_row)):
        if len(rows) >= budget:
            flag = True
            break
        node_ok = masks[cand_row[c]]
        if not node_ok.any():
            continue
        e, take = jffd.preemption_plan(node_free, victim_prio, victim_req, victim_ok, node_ok,
                                       need[c], np.int32(prio[c]))
        e = int(e)
        if e < 0:
            continue
        hot = np.flatnonzero(np.asarray(take)[e])
        if not len(hot):
            continue
        for v in hot:
            rows.append((c, e, int(v)))
            node_free[e] += victim_req[e, int(v)]
            victim_ok[e, int(v)] = False
        # the JAX pass's need is a list of python ints: the difference is int64
        node_free[e] = np.maximum(node_free[e] - [int(x) for x in need[c]], 0)
    return rows, flag, node_free, victim_ok


def walk_tables(rng, E=None, Vm=None, R=None, C=None, U=None, free_hi=4, req_hi=3, need_hi=6):
    # E, Vm and R from a few values each: the JAX plan compiles once per shape
    E = E or int(rng.choice([1, 5, 33, 64]))
    Vm = Vm or int(rng.choice([1, 4, 8]))
    R = R or int(rng.choice([1, 3, 5]))
    C = C or int(rng.integers(1, 41))
    U = U or int(rng.integers(1, 5))
    node_free = rng.integers(0, free_hi, (E, R)).astype(np.int32)
    victim_prio = np.sort(rng.integers(0, 6, (E, Vm)), axis=1).astype(np.int32)
    victim_req = rng.integers(0, req_hi, (E, Vm, R)).astype(np.int32)
    victim_ok = rng.random((E, Vm)) < 0.8
    masks = rng.random((U, E)) < 0.8
    cand_row = rng.integers(0, U, C).astype(np.int32)
    need = rng.integers(1, need_hi, (C, R)).astype(np.int32)
    prio = rng.integers(0, 8, C).astype(np.int32)
    return node_free, victim_prio, victim_req, victim_ok, masks, cand_row, need, prio


def check_walk(tables, budget, host_legs=True):
    """preemption_walk_plain and every port leg against jax_walk; returns
    (rows, flag)."""
    rows, flag, free, ok = jax_walk(*tables, budget)
    out = tffd.preemption_walk_plain(*[torch.from_numpy(np.ascontiguousarray(a)) for a in tables],
                                     budget)
    wire = out.wire.numpy()
    C, Vm = len(tables[5]), tables[1].shape[1]
    assert wire.shape == (2 + 3 * tffd.walk_capacity(budget, Vm, C),)
    assert tffd.unpack_walk(wire) == (rows, flag)
    assert (wire[2 + 3 * len(rows):] == -1).all()
    assert np.array_equal(out.node_free.numpy(), free)
    assert np.array_equal(out.victim_ok.numpy(), ok)
    for name in ("device", "host", "oracle") if host_legs else ("device",):
        kw = {"device": "cpu"} if name == "device" else {}
        got_rows, got_flag, final = tsc.WALKS[name](tables[:4], *tables[4:], budget, **kw)
        assert (got_rows, got_flag) == (rows, flag), name
        assert np.array_equal(np.asarray(final[0]), free), name
        assert np.array_equal(np.asarray(final[3]), ok), name
    return rows, flag


def walk_chunked(name, tables, cuts, budget):
    """scheduling_class.walk_in_chunks over WALKS[name], the candidates
    cut into chunks at `cuts`, each chunk's node rows its own table."""
    masks, cand_row, need, prio = tables[4:]
    bounds = [0, *cuts, len(cand_row)]
    starts = {lo: hi for lo, hi in zip(bounds, bounds[1:])}

    def chunk_at(lo):
        hi = starts[lo]
        used, local = np.unique(cand_row[lo:hi], return_inverse=True)
        return masks[used], local.astype(np.int32), need[lo:hi], prio[lo:hi]

    walk = tsc.WALKS[name]
    if name == "device":
        walk = functools.partial(walk, device="cpu")
    return tsc.walk_in_chunks(walk, tables[:4], chunk_at, len(cand_row), budget)


@pytest.mark.parametrize("seed", range(6))
def test_walk_seeded(seed):
    rng = np.random.default_rng(300 + seed)
    evicted = 0
    for _ in range(4):
        rows, _flag = check_walk(walk_tables(rng), int(rng.integers(1, 40)))
        evicted += len(rows)
    assert evicted


def test_walk_budget_zero_and_no_candidates():
    rng = np.random.default_rng(5)
    tables = walk_tables(rng, E=8, Vm=4, R=2, C=5)
    assert check_walk(tables, 0) == ([], True)
    empty = tables[:5] + (np.zeros(0, np.int32), np.zeros((0, 2), np.int32),
                          np.zeros(0, np.int32))
    assert check_walk(empty, 3) == ([], False)


def test_walk_budget_crossed_inside_a_candidate():
    """Budget 3 and two-victim plans: the second candidate starts at 2 < 3
    and takes 2 (count 4), the third is declined."""
    E, Vm, R = 4, 4, 1
    tables = (np.zeros((E, R), np.int32), np.zeros((E, Vm), np.int32),
              np.ones((E, Vm, R), np.int32), np.ones((E, Vm), bool), np.ones((1, E), bool),
              np.zeros(5, np.int32), np.full((5, R), 2, np.int32), np.full(5, 9, np.int32))
    rows, flag = check_walk(tables, 3)
    assert flag and rows == [(0, 0, 0), (0, 0, 1), (1, 0, 2), (1, 0, 3)]


@pytest.mark.parametrize("seed", range(4))
def test_walk_in_chunks_equals_one_walk(seed):
    """A walk cut into chunks, each under the budget left and on the
    tables the chunk before it left, gives one walk's rows, flag and final
    tables on every leg, the budget reached inside a chunk or between two."""
    rng = np.random.default_rng(500 + seed)
    flags = 0
    for _ in range(4):
        tables = walk_tables(rng, C=int(rng.integers(2, 41)))
        budget = int(rng.integers(1, 30))
        rows, flag, free, ok = jax_walk(*tables, budget)
        C = len(tables[5])
        for cuts in ([], sorted(set(rng.integers(1, C, 3).tolist())), list(range(1, C))):
            for name in ("device", "host", "oracle"):
                got_rows, got_flag, final = walk_chunked(name, tables, cuts, budget)
                assert (got_rows, got_flag) == (rows, flag), (name, cuts)
                assert np.array_equal(np.asarray(final[0]), free), (name, cuts)
                assert np.array_equal(np.asarray(final[3]), ok), (name, cuts)
        flags += flag
    assert flags


def test_walk_free_fit_charges_nothing():
    """A candidate that fits in free capacity alone evicts nothing and
    leaves the free table as it was, so the next one sees the same room."""
    E, Vm, R = 3, 2, 2
    free = np.array([[0, 0], [5, 5], [0, 0]], np.int32)
    tables = (free, np.zeros((E, Vm), np.int32), np.ones((E, Vm, R), np.int32),
              np.ones((E, Vm), bool), np.array([[False, True, True], [True, False, True]]),
              np.array([0, 0, 1], np.int32), np.array([[3, 3], [4, 4], [1, 1]], np.int32),
              np.full(3, 9, np.int32))
    rows, flag, free_after, _ = jax_walk(*tables, 10)
    assert np.array_equal(free_after[1], [5, 5])  # two free fits, no charge
    assert rows == [(2, 0, 0)] and not flag
    check_walk(tables, 10)


def test_walk_all_false_rows_and_equal_priority():
    """All-false node rows plan nothing; victims at the candidate's own
    priority are ineligible (strictly lower only)."""
    rng = np.random.default_rng(9)
    for _ in range(6):
        node_free, vprio, vreq, vok, masks, cand_row, need, prio = walk_tables(rng, U=3)
        masks[1] = False
        prio[:] = 3
        vprio[:, : vprio.shape[1] // 2] = 3  # the lower half sorts first: equal priority
        vprio.sort(axis=1)
        check_walk((node_free, vprio, vreq, vok, masks, cand_row, need, prio), 30)
    # one node, its only victim at the candidate's priority: no plan
    t = (np.zeros((1, 1), np.int32), np.full((1, 1), 4, np.int32), np.ones((1, 1, 1), np.int32),
         np.ones((1, 1), bool), np.ones((1, 1), bool), np.zeros(1, np.int32),
         np.ones((1, 1), np.int32), np.full(1, 4, np.int32))
    assert check_walk(t, 5) == ([], False)


def test_walk_int32_wrap():
    """Free tables near 2**31 and reclaims near 2**30: the plan's prefix
    sums and the free + reclaim update wrap as int32 (the device legs
    follow XLA's int32; the int64 host mirror and the oracle's python ints
    sit out, as in the single-plan tests)."""
    rng = np.random.default_rng(13)
    wrapped = 0
    for _ in range(8):
        tables = walk_tables(rng, free_hi=2**31 - 1, req_hi=BIG, need_hi=2**31 - 1)
        node_free, vprio, vreq, vok, masks, cand_row, need, prio = tables
        rows, flag = check_walk(tables, 40, host_legs=False)
        wrapped += sum(int(node_free[e].astype(np.int64).sum()
                           + vreq[e, v].astype(np.int64).sum() > 2**31 - 1)
                       for _, e, v in rows)
    assert wrapped


# ---------------------------------------------------------------------------
# The keyed node rows
# ---------------------------------------------------------------------------


def _mask_fleet(seed: int):
    rng = np.random.default_rng(seed)
    nodes = []
    for e in range(12):
        n = mknode(f"n{e}", zone=ZONES[e % 3], schedulable=e % 5 != 4)
        taints = [Taint(key="dedicated", value=["gpu", "db"][e % 2], effect="NoSchedule")] \
            if e % 3 == 1 else []
        if e % 4 == 2:
            taints.append(Taint(key="soft", value="x", effect="PreferNoSchedule"))
        nodes.append(dataclasses.replace(n, taints=taints,
                                         labels={**n.labels, "tier": ["a", "b"][e % 2]}))
    selectors = [{}, {"tier": "a"}, {"topology.kubernetes.io/zone": ZONES[1]}]
    tolerations = [[], [Toleration(key="dedicated", operator="Equal", value="gpu",
                                   effect="NoSchedule")],
                   [Toleration(key="dedicated", operator="Exists")]]
    affinities = [[], [Requirements.of(Requirement.create("tier", NOT_IN, ["b"]))],
                  [Requirements.of(Requirement.create("tier", IN, ["a", "b"]))]]
    pods = []
    for i in range(40):
        pods.append(mkpod(f"p{i}", priority=100,
                          node_selector=dict(selectors[int(rng.integers(0, 3))]),
                          tolerations=list(tolerations[int(rng.integers(0, 3))]),
                          node_affinity=list(affinities[int(rng.integers(0, 3))]),
                          volume_zones=[None, (ZONES[0],), ()][int(rng.integers(0, 3))]))
    return to_port(SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES))


@pytest.mark.parametrize("seed", range(3))
def test_node_ok_table_matches_node_ok_mask(seed):
    inp = _mask_fleet(seed)
    masks, row = tsc.node_ok_table(inp.pods, inp.nodes)
    assert masks.shape == (int(row.max()) + 1, len(inp.nodes)) and masks.dtype == bool
    for p, r in zip(inp.pods, row):
        assert np.array_equal(masks[r], tsc.node_ok_mask(p, inp.nodes)), p.meta.uid
    assert len({tsc.mask_key(p) for p in inp.pods}) == masks.shape[0]
    # the fleet tells the rows apart: several distinct masks, one empty
    assert len({m.tobytes() for m in masks}) > 2 and not masks.all()


def test_node_ok_table_one_row_for_equal_pods(monkeypatch):
    inp = to_port(SolverInput(pods=[mkpod(f"hi-{i}", priority=100) for i in range(30)],
                              nodes=[mknode(f"n{e}") for e in range(5)], nodepools=[],
                              zones=ZONES))
    calls = []
    mask = tsc.node_ok_mask
    monkeypatch.setattr(tsc, "node_ok_mask", lambda p, nodes: calls.append(p) or mask(p, nodes))
    masks, row = tsc.node_ok_table(inp.pods, inp.nodes)
    assert masks.shape == (1, 5) and not row.any() and len(calls) == 1
    assert tsc.node_ok_table([], inp.nodes)[0].shape == (0, 5)


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_node_ok_table_chunks(max_new, monkeypatch):
    """With max_new, a call stops before the max_new + 1-th key not in
    the cache, and the cache carries the rows on: the chunks' rows are
    node_ok_mask's and each key's row is built once."""
    inp = _mask_fleet(0)
    calls = []
    mask = tsc.node_ok_mask
    monkeypatch.setattr(tsc, "node_ok_mask", lambda p, nodes: calls.append(p) or mask(p, nodes))
    cache, lo, seen = {}, 0, set()
    while lo < len(inp.pods):
        masks, row = tsc.node_ok_table(inp.pods[lo:], inp.nodes, cache, max_new)
        chunk = inp.pods[lo:lo + len(row)]
        assert len(row) >= 1 and masks.shape[0] == int(row.max()) + 1
        for p, r in zip(chunk, row):
            assert np.array_equal(masks[r], mask(p, inp.nodes)), p.meta.uid
        new = {tsc.mask_key(p) for p in chunk} - seen
        assert len(new) <= max_new
        if lo + len(row) < len(inp.pods):  # stopped at a new key past max_new
            assert len(new) == max_new and tsc.mask_key(inp.pods[lo + len(row)]) not in new | seen
        seen |= new
        lo += len(row)
    assert len(calls) == len(seen) == len(cache)


# ---------------------------------------------------------------------------
# The class pass around the walk
# ---------------------------------------------------------------------------


def _two_victim_fleet():
    nodes = [mknode(f"n{e}", cpu="0", mem="0Mi", victims=[
        victim(f"v-{e}-{v}", priority=0, cpu="1", mem="1Gi") for v in range(4)])
        for e in range(2)]
    pods = [mkpod(f"hi{i}", cpu="2", mem="2Gi", priority=100) for i in range(4)]
    return SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES)


def test_budget_crossed_mid_candidate_parity(monkeypatch):
    """Budget 3, two-victim plans: the second candidate carries the count
    to 4, the third is declined (once), on every leg."""
    monkeypatch.setattr(jsc, "MAX_EVICTIONS_PER_SOLVE", 3)
    monkeypatch.setattr(tsc, "MAX_EVICTIONS_PER_SOLVE", 3)
    res, caw = assert_class_parity(_two_victim_fleet())
    assert len(res.evictions) == 4 and caw.class_stats["declines"] == 1
    assert caw.class_stats["preemptions"] == 4
    for leg in ("oracle", "host"):
        got_caw = tsc.ClassAwareSolver(TorchSolver(device="cpu"), planner=leg)
        got = got_caw.solve(to_port(_two_victim_fleet()))
        assert _evictions(got) == _evictions(res) and got_caw.class_stats == caw.class_stats


def _many_keys_fleet(n_pods=12):
    """Candidates whose tolerations differ (a mask_key each, every node
    row the same), two-victim plans: a chunk of WALK_CHUNK_KEYS candidates."""
    nodes = [mknode(f"n{e}", cpu="0", mem="0Mi", victims=[
        victim(f"v-{e}-{v}", priority=0, cpu="1", mem="1Gi") for v in range(4)])
        for e in range(6)]
    pods = [mkpod(f"hi{i:02d}", cpu="2", mem="2Gi", priority=100,
                  tolerations=[Toleration(key=f"t{i}", operator="Exists")])
            for i in range(n_pods)]
    return SolverInput(pods=pods, nodes=nodes, nodepools=[], zones=ZONES)


@pytest.mark.parametrize("chunk_keys,budget", [(2, 7), (2, 8), (3, 256), (32, 7)])
def test_many_keys_walk_in_chunks_parity(chunk_keys, budget, monkeypatch):
    """A class pass whose candidates all carry distinct keys: chunks of
    chunk_keys candidates, the budget reached inside a chunk (7: the fourth
    candidate carries the count to 8) or at a chunk's end (8), or never.
    Decisions and class_stats equal both JAX legs' and the port's other
    legs'; node rows are built only for the chunks walked, and the device
    leg makes one walk call a chunk."""
    monkeypatch.setattr(jsc, "MAX_EVICTIONS_PER_SOLVE", budget)
    monkeypatch.setattr(tsc, "MAX_EVICTIONS_PER_SOLVE", budget)
    monkeypatch.setattr(tsc, "WALK_CHUNK_KEYS", chunk_keys)
    calls = []
    mask = tsc.node_ok_mask
    monkeypatch.setattr(tsc, "node_ok_mask", lambda p, nodes: calls.append(p) or mask(p, nodes))
    before = dict(tsc.PLANNER_TRANSFER)
    res, caw = assert_class_parity(_many_keys_fleet())
    walked = min(12, -(-budget // 2))  # two evictions a candidate
    chunks = -(-walked // chunk_keys)
    assert len(res.evictions) == 2 * walked
    assert caw.class_stats["declines"] == int(walked < 12)
    assert tsc.PLANNER_TRANSFER["walk_calls"] - before["walk_calls"] == chunks
    assert len(calls) == min(12, chunks * chunk_keys)
    for leg in ("oracle", "host"):
        got_caw = tsc.ClassAwareSolver(TorchSolver(device="cpu"), planner=leg)
        got = got_caw.solve(to_port(_many_keys_fleet()))
        assert _evictions(got) == _evictions(res) and got_caw.class_stats == caw.class_stats


def test_device_leg_one_walk_call_tables_once():
    """A device-leg class solve on the CPU: one walk call, no plan call,
    the tables uploaded once (their exact bytes) and the wire fetched once."""
    inp = to_port(_two_victim_fleet())
    caw = tsc.ClassAwareSolver(TorchSolver(device="cpu"))
    seen = []
    walk = tffd.preemption_walk

    def recording(*a):
        seen.append([x.clone() if isinstance(x, torch.Tensor) else x for x in a])
        return walk(*a)

    before = dict(tsc.PLANNER_TRANSFER)
    try:
        tffd.preemption_walk = recording
        res = caw.solve(inp)
    finally:
        tffd.preemption_walk = walk
    delta = {k: tsc.PLANNER_TRANSFER[k] - before[k] for k in before}
    assert len(res.evictions) == 8 and len(seen) == 1
    tables, budget = seen[0][:-1], seen[0][-1]
    assert budget == tsc.MAX_EVICTIONS_PER_SOLVE
    assert delta["walk_calls"] == 1 and delta["plan_calls"] == 0 and delta["gang_calls"] == 0
    assert delta["h2d_bytes"] == sum(t.numel() * t.element_size() for t in tables)
    E, Vm = tables[1].shape
    C = tables[5].shape[0]
    assert tables[4].shape == (1, E) and C == 4
    assert delta["d2h_bytes"] == 4 * (2 + 3 * tffd.walk_capacity(budget, Vm, C))
