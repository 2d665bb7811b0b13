"""The port's decision provenance (karpenter_tpu_torch/obs/explain.py, the
explain side kernel's plain version and TorchSolver's captures) against the
JAX package's, on the CPU.

- The wire: the plain explain_pack (the plain version K12 is held to on the
  card) against the JAX ffd.explain_pack on seeded tables padded as the
  backends pad them, zero-width zone/ct axes, top_k above the node count and
  a node axis past uint16; reason_codes / rejection_table / host_table
  against the reference's.
- Records: TorchSolver(device="cpu") captures, with and without the class
  wrapper, fingerprint as the JAX TPUSolver's and ReferenceSolver's on the
  same inputs (basic, unschedulable, relax ladder, resumed, preemption,
  gang verdicts); the device-table record equals the host-derived one.
- Off path: explain off stores nothing, dispatches no side kernel and moves
  no extra bytes.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.obs import explain as jx
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import scheduling_class as jsc
from karpenter_tpu.solver.backend import ReferenceSolver, TPUSolver
from karpenter_tpu.solver.encode import encode as jencode_fn
from karpenter_tpu.solver.encode import quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.obs import explain as tx
from karpenter_tpu_torch.solver import encode as tenc
from karpenter_tpu_torch.solver import scheduling_class as tsc
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_scheduling_class import gang_labels, mknode, victim
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import to_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _explain_defaults():
    for m in (jx, tx):
        m.configure(enabled=False)
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)
    yield
    for m in (jx, tx):
        m.configure(enabled=False)


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------


def _random_tables(rng, G, E, S, R=2, Z=2, C=2):
    return {
        "take_e": rng.integers(0, 3, size=(S, E), dtype=np.int32),
        "run_group": rng.integers(0, G, size=S, dtype=np.int32),
        "group_req": rng.integers(0, 4, size=(G, R), dtype=np.int32),
        "node_free": rng.integers(0, 16, size=(E, R), dtype=np.int32),
        "node_compat": rng.random((G, E)) < 0.8,
        "node_zone": rng.integers(-1, Z, size=E, dtype=np.int32),
        "node_ct": rng.integers(-1, C, size=E, dtype=np.int32),
        "group_zone": rng.random((G, Z)) < 0.7,
        "group_ct": rng.random((G, C)) < 0.7,
        "group_topo": rng.random(G) < 0.2,
        "group_aff": rng.random(G) < 0.2,
    }


def _padded(t, G):
    """Pad exactly like TorchSolver._device_explain (and the JAX backend)."""
    Gp = 1 << (max(G, 1) - 1).bit_length()
    Z = max(1, t["group_zone"].shape[1])
    C = max(1, t["group_ct"].shape[1])
    R = t["group_req"].shape[1]
    E = t["node_free"].shape[0]

    def pad(a, shape, fill=False):
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    return [t["take_e"], t["run_group"], pad(t["group_req"], (Gp, R), 0),
            t["node_free"], pad(t["node_compat"], (Gp, E)), t["node_zone"], t["node_ct"],
            pad(t["group_zone"], (Gp, Z)), pad(t["group_ct"], (Gp, C)),
            pad(t["group_topo"], (Gp,)), pad(t["group_aff"], (Gp,))]


def _both(t, G, E, k, e_count=None, g_count=None):
    """(JAX wire, port plain wire) on the padded tables."""
    args = _padded(t, G)
    ec = E if e_count is None else e_count
    gc = G if g_count is None else g_count
    want = np.asarray(jffd.explain_pack(*args, np.int32(ec), np.int32(gc), top_k=k))
    got = tffd.explain_pack(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args], ec, gc,
                            top_k=k).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.shape[0] == tffd.explain_words(args[2].shape[0], k)
    return want, got


@pytest.mark.parametrize("seed", range(6))
def test_wire_equals_jax_and_host_deriver(seed):
    # tests/test_explain.py test_randomized_tables_bit_equal
    rng = np.random.default_rng(seed)
    G, E, S, k = (int(rng.integers(1, 9)), int(rng.integers(1, 20)),
                  int(rng.integers(1, 30)), int(rng.integers(1, 6)))
    t = _random_tables(rng, G, E, S)
    want, got = _both(t, G, E, k)
    assert np.array_equal(got, want)
    # padded nodes and groups count nothing
    want_p, got_p = _both(t, G, E, k, e_count=E // 2, g_count=max(0, G - 1))
    assert np.array_equal(got_p, want_p)
    codes = tx.reason_codes(**t)
    assert np.array_equal(codes, jx.reason_codes(**t))
    n_rej, words = tx.rejection_table(codes, k)
    j_rej, j_words = jx.rejection_table(codes, k)
    assert np.array_equal(n_rej, j_rej) and np.array_equal(words, j_words)
    overflow, d_rej, d_words = tffd.unpack_explain(got, G)
    assert not overflow and np.array_equal(d_rej, n_rej) and np.array_equal(d_words, words)


def test_zero_width_zone_ct_axes():
    # tests/test_explain.py test_zero_width_zone_ct_axes
    rng = np.random.default_rng(7)
    t = _random_tables(rng, 3, 5, 8)
    t["group_zone"] = np.zeros((3, 0), bool)
    t["group_ct"] = np.zeros((3, 0), bool)
    t["node_zone"] = np.full(5, -1, np.int32)
    t["node_ct"] = np.full(5, -1, np.int32)
    want, got = _both(t, 3, 5, 4)
    assert np.array_equal(got, want)
    _, d_rej, d_words = tffd.unpack_explain(got, 3)
    h_rej, h_words = tx.rejection_table(tx.reason_codes(**t), 4)
    assert np.array_equal(d_rej, h_rej) and np.array_equal(d_words, h_words)


@pytest.mark.parametrize("k", [8, 40])
def test_top_k_above_node_count_pads_empty(k):
    # tests/test_explain.py test_fewer_nodes_than_top_k_pads_empty
    rng = np.random.default_rng(9)
    t = _random_tables(rng, 2, 3, 4)
    want, got = _both(t, 2, 3, k)
    assert np.array_equal(got, want)
    _, _, words = tffd.unpack_explain(got, 2)
    assert words.shape == (2, k) and (words[:, 3:] == -1).all()


def test_uint16_overflow_carve_out():
    """A node axis past uint16 sets the wire's overflow flag (as the JAX
    kernel's), and TorchSolver skips the dispatch, counted, so the host
    deriver rebuilds the table."""
    E = 0x10000 + 1
    t = {"take_e": np.zeros((2, E), np.int32), "run_group": np.zeros(2, np.int32),
         "group_req": np.ones((1, 1), np.int32), "node_free": np.ones((E, 1), np.int32),
         "node_compat": np.ones((1, E), bool), "node_zone": np.full(E, -1, np.int32),
         "node_ct": np.full(E, -1, np.int32), "group_zone": np.zeros((1, 1), bool),
         "group_ct": np.zeros((1, 1), bool), "group_topo": np.zeros(1, bool),
         "group_aff": np.zeros(1, bool)}
    want, got = _both(t, 1, E, 2)
    assert np.array_equal(got, want) and got[0] == 1
    assert tffd.unpack_explain(got, 1)[0] is True
    s = TorchSolver(device="cpu")

    class _Out:
        take_e = torch.zeros((1, E), dtype=torch.int32)

    assert s._device_explain(None, _Out()) is None
    assert s.stats["explain_wide"] == 1 and s.stats["explain_dispatches"] == 0


def test_placed_node_is_always_feasible():
    # tests/test_explain.py test_placed_node_is_always_feasible
    t = {"take_e": np.array([[2]], np.int32), "run_group": np.array([0], np.int32),
         "group_req": np.array([[4]], np.int32), "node_free": np.array([[8]], np.int32),
         "node_compat": np.ones((1, 1), bool), "node_zone": np.array([-1], np.int32),
         "node_ct": np.array([-1], np.int32), "group_zone": np.zeros((1, 0), bool),
         "group_ct": np.zeros((1, 0), bool), "group_topo": np.zeros(1, bool),
         "group_aff": np.zeros(1, bool)}
    assert tx.reason_codes(**t)[0, 0] == tx.REASON_FEASIBLE
    want, got = _both(t, 1, 1, 2)
    assert np.array_equal(got, want) and got[3] == 0


def test_reason_names_match_the_wire():
    assert tx.REASON_NAMES == jx.REASON_NAMES
    assert {name: code for name, code in tffd.EXPLAIN_REASONS} == {
        n: c for c, n in tx.REASON_NAMES.items()}


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def _entry(store_mod):
    ents = store_mod.store().recent(1)
    assert ents, "explain enabled but nothing captured"
    return ents[0]


def _records(inp, wrap=False, solver=None):
    """(oracle entry, TPU entry, port entry) of one solve each, explain on."""
    out = []
    for mod, make, q, conv in ((jx, ReferenceSolver, True, False), (jx, TPUSolver, False, False),
                               (tx, None, False, True)):
        mod.configure(enabled=True, top_k=8)
        s = (solver if solver is not None else TorchSolver(device="cpu")) if conv else make()
        if wrap:
            s = (tsc if conv else jsc).ClassAwareSolver(s)
        x = to_port(inp) if conv else inp
        s.solve(quantize_input(x) if q else x)
        out.append(_entry(mod))
    return out


def _assert_same(entries):
    base = entries[0]
    for e in entries[1:]:
        assert e["fingerprint"] == base["fingerprint"], (
            jx.diff_records(base["record"], e["record"])[:8])
    return entries[-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_basic_records_match(seed):
    # tests/test_explain.py test_randomized_basic
    rng = random.Random(seed)
    pods = [mkpod(f"p{i:03d}", cpu=f"{rng.choice([250, 500, 1000, 2000])}m",
                  mem=f"{rng.choice([256, 512, 1024, 4096])}Mi") for i in range(30)]
    inp = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)
    s = TorchSolver(device="cpu")
    ent = _assert_same(_records(inp, solver=s))
    assert ent["annotations"] == {"source": "device", "backend": "torch"}
    assert len(ent["record"]["pods"]) == 30
    assert s.stats["explain_dispatches"] == 1 and s.stats["explain_host_derived"] == 0


def test_unschedulable_pods_surface_as_unplaced():
    # tests/test_explain.py test_unschedulable_pods_surface_as_unplaced
    inp = SolverInput(pods=[mkpod("ok", cpu="500m"), mkpod("huge", cpu="999")], nodes=[],
                      nodepools=[pool()], zones=ZONES)
    rec = _assert_same(_records(inp))["record"]
    assert "huge" in rec["unplaced"] and rec["pods"]["huge"]["chosen"] is None


def test_existing_nodes_device_table_matches_host():
    """Rejections on existing nodes (resources, zones), from the device
    table, equal the host deriver's over the same final decisions."""
    rng = random.Random(4)
    nodes = [mknode(f"n{e}", cpu=str(rng.choice([1, 2, 4])), mem="4Gi",
                    zone=ZONES[e % 3]) for e in range(6)]
    pods = [mkpod(f"p{i:02d}", cpu=rng.choice(["500m", "1", "2"])) for i in range(14)]
    inp = SolverInput(pods=pods, nodes=nodes, nodepools=[pool()], zones=ZONES)
    ent = _assert_same(_records(inp))
    assert ent["annotations"]["source"] == "device"
    assert any(g["n_rejected"] for g in ent["record"]["groups"])
    tx.configure(enabled=True, top_k=8)
    s = TorchSolver(device="cpu")
    res = s.solve(to_port(inp))
    enc = tenc.encode(tenc.quantize_input(to_port(inp)))
    host = tx.build_record(enc, res, k=8)
    dev = tx.build_record(enc, res, k=8, table=res._explain_table)
    assert tx.fingerprint(host) == tx.fingerprint(dev)
    j = jx.host_table(jencode_fn(quantize_input(inp)), res.placements, 8)
    h = tx.host_table(enc, res.placements, 8)
    assert all(np.array_equal(a, b) for a, b in zip(h, j))


def test_relax_ladder_record_matches():
    # tests/test_explain.py test_relax_ladder_leg_captures_and_matches
    from karpenter_tpu.api.objects import TopologySpreadConstraint

    sel = {"app": "soft"}
    pods = [mkpod(f"s{i}", labels=dict(sel), topology_spread=[TopologySpreadConstraint(
        max_skew=1, topology_key="topology.kubernetes.io/zone", label_selector=sel,
        when_unsatisfiable="ScheduleAnyway")]) for i in range(3)]
    inp = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)
    s = TorchSolver(device="cpu")
    ent = _assert_same(_records(inp, solver=s))
    assert s.stats["ladder_solves"] == 1
    assert ent["annotations"]["source"] == "host" and ent["annotations"]["ladder_rungs"] >= 1
    h = TorchSolver(device="cpu", relax_ladder=False)
    ent = _assert_same(_records(inp, solver=h))
    assert ent["annotations"]["relax_dispatches"] == h.stats["relax_dispatches"]


def test_resumed_solve_host_derives_and_matches():
    # tests/test_explain.py test_resumed_solve_host_derives_and_matches
    from tests.test_scan_resume import _add_replica, _fleet

    inp = _fleet()
    tail = _add_replica(inp, 0, "tail-0")
    warm = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
    tx.configure(enabled=True, top_k=8)
    warm.solve(to_port(inp))
    warm.solve(to_port(tail))
    assert warm.stats["resume_solves"] == 1, warm.stats
    ent = _entry(tx)
    assert ent["annotations"]["source"] == "host"
    assert warm.stats["explain_dispatches"] == 1 and warm.stats["explain_host_derived"] == 1
    jx.configure(enabled=True, top_k=8)
    ReferenceSolver().solve(quantize_input(tail))
    _assert_same([_entry(jx), ent])


def test_preemption_rides_the_record():
    # tests/test_explain.py test_preemption_rides_the_record
    nodes = [mknode("n1", cpu="0", mem="0Mi",
                    victims=[victim("lo", priority=0), victim("lo2", priority=1)])]
    inp = SolverInput(pods=[mkpod("hi", cpu="2", mem="2Gi", priority=100)], nodes=nodes,
                      nodepools=[], zones=ZONES)
    rec = _assert_same(_records(inp, wrap=True))["record"]
    assert rec["preemptions"][0]["victim"] == "lo" and rec["preemptions"][0]["for_pod"] == "hi"


def test_gang_verdicts_ride_the_record():
    # tests/test_explain.py test_gang_verdicts_ride_the_record
    committed = [mkpod(f"g{i}", cpu="500m", labels=gang_labels("job-a", 3)) for i in range(3)]
    doomed = [mkpod(f"d{i}", cpu="999", labels=gang_labels("job-b", 2)) for i in range(2)]
    inp = SolverInput(pods=committed + doomed, nodes=[], nodepools=[pool()], zones=ZONES)
    ent = _assert_same(_records(inp, wrap=True))
    rec = ent["record"]
    assert rec["gangs"]["job-a"] == {"committed": True, "placed": 3, "min_ranks": 3}
    assert rec["gangs"]["job-b"]["committed"] is False
    assert rec["gangs_unschedulable"] == ["job-b"]
    assert ent["annotations"]["backend"] == "class"


def test_class_fleet_records_match():
    """The class fleet (gang rollback + preemption), cut to 12 nodes: the
    class-level record and the inner solves' device-table records equal
    the JAX TPU leg's, capture by capture."""
    import bench

    inp = bench._gang_input(n_nodes=12, victims_per_node=4, n_high=30, n_gangs=5, gang_size=4)
    for m in (jx, tx):
        m.configure(enabled=True, top_k=8)
    jsc.ClassAwareSolver(TPUSolver()).solve(inp)
    tsc.ClassAwareSolver(TorchSolver(device="cpu")).solve(to_port(inp))
    je, te = jx.store().recent(), tx.store().recent()
    assert len(je) == len(te) == 3
    for a, b in zip(je, te):
        assert a["annotations"]["source"] == b["annotations"]["source"]
        assert a["fingerprint"] == b["fingerprint"], jx.diff_records(a["record"], b["record"])[:8]
    assert te[-1]["record"]["preemptions"] and te[-1]["record"]["gangs"]["job-doomed"] == {
        "committed": False, "placed": 0, "min_ranks": 4}


# ---------------------------------------------------------------------------
# Off path and the store
# ---------------------------------------------------------------------------


def test_explain_off_stores_and_moves_nothing():
    # tests/test_explain.py test_explain_off_moves_zero_extra_d2h_bytes
    pods = [mkpod(f"p{i}", cpu="500m") for i in range(12)]
    inp = to_port(SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES))
    s = TorchSolver(device="cpu")
    s.solve(inp)

    def delta():
        f0 = s.ledger.total["d2h_bytes"]
        s.solve(inp)
        return s.ledger.total["d2h_bytes"] - f0

    off1, off2 = delta(), delta()
    assert off1 == off2 and len(tx.store()) == 0 and s.stats["explain_dispatches"] == 0
    tx.configure(enabled=True, top_k=4)
    on = delta()
    assert on == off1 + tffd.explain_words(1, 4) * 4 and s.stats["explain_dispatches"] == 1
    tx.configure(enabled=False)
    assert delta() == off1 and s.stats["explain_dispatches"] == 1


def test_disabled_hooks_are_inert():
    # tests/test_explain.py test_disabled_capture_returns_none_and_stores_nothing
    assert tx.capture(None, None, "test") is None
    tx.note("gang", {"gang": "g"})
    assert len(tx.store()) == 0 and tx._drain_notes() == {}


def test_store_defers_merges_and_evicts():
    # tests/test_explain.py test_capture_defers_and_reads_materialize,
    # test_merge_put_unions_annotations and test_ring_evicts_oldest
    tx.configure(enabled=True, top_k=4)
    TorchSolver(device="cpu").solve(to_port(SolverInput(
        pods=[mkpod(f"p{i}", cpu="500m") for i in range(4)], nodes=[], nodepools=[pool()],
        zones=ZONES)))
    st = tx.store()
    with st._lock:
        raw = next(iter(st._entries.values()))
    assert "_defer" in raw and "record" not in raw
    assert raw["tenant_id"] is None and raw["journal_seq"] is None
    ent = st.recent(1)[0]
    assert "record" in ent and st.recent(1)[0]["fingerprint"] == ent["fingerprint"]
    assert st.by_pod("p2") and st.by_pod("nope") == []
    ring = tx.ExplainStore(ring=2)
    ring.put("s1", {"solve_id": "s1", "record": {"pods": {}}, "annotations": {"rungs": 2}})
    out = ring.put("s1", {"solve_id": "s1", "record": {"pods": {"p": {}}},
                          "annotations": {"source": "host"}})
    assert out["annotations"] == {"source": "host", "rungs": 2}
    for i in range(2, 5):
        ring.put(f"s{i}", {"solve_id": f"s{i}", "record": {"pods": {}}, "annotations": {}})
    assert len(ring) == 2 and ring.get("s1") is None and ring.get("s4") is not None
    a = {"x": [1, {"y": 2}]}
    assert tx.diff_records(a, {"x": [1, {"y": 3}]}) == jx.diff_records(a, {"x": [1, {"y": 3}]})
