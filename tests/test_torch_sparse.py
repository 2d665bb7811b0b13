"""The port's sparse V/Q scan against the JAX package's sparse twins.

Four levels, all exact (every output is an integer or a bit pattern):

- layout and gate: the port's sparse_run_tables / constraint_density /
  use_sparse_constraints equal the JAX ones on the fleets of
  tests/test_sparse_constraints.py, in ladder mode too;
- raw outputs: each plain sparse entry point (ffd_solve_sparse,
  ffd_solve_ckpt_sparse with its ring, ffd_resume_sparse,
  ffd_solve_ladder_sparse) equals its JAX twin on the arguments and index
  tables TPUSolver(sparse="on") dispatches, and equals the dense plain
  scan; index rows with -1 interleaved and extra non-member columns, the
  Q = 0 and V = 0 edges, and a dense ring resumed through the sparse resume
  (and the other way round) decide the same;
- solver: TorchSolver(device="cpu", sparse=...) equals TPUSolver(sparse=...)
  in decisions and sparse_dispatches for sparse in {on, auto, off}, on the
  spread, affinity and mixed-with-nodes fleets, a hostname fleet (the fast
  instance), a hostname fleet wide enough for "auto" and a preference
  fleet (the ladder);
- transfers: the ledger's per-solve bytes, arrays and messages equal the
  JAX ledger's over a cold / exact-repeat / tail-resume sequence.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.api import wellknown as wk
from karpenter_tpu.api.objects import PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.convert import (
    args_to_torch,
    array_to_torch,
    output_to_numpy,
    ring_to_numpy,
    state_to_numpy,
)
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_sparse_constraints import (
    _affinity_fleet,
    _fake_enc,
    _filler,
    _spread_fleet,
)
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import FLEETS as RELAX_FLEETS
from tests.test_torch_relax import _capture, to_port
from tests.test_torch_solver import CASES, as_data, build
from tests.test_zone_device import ZONES, mknode, mkpod, pool

torch.set_num_threads(1)


# -- layout and gate ------------------------------------------------------------


def _fake_encs():
    """The fake encodes of tests/test_sparse_constraints.py's layout and gate
    tests, and seeded random ones (owners too)."""
    q_act = np.zeros((3, 10), bool)
    q_act[0, [1, 9]] = True
    q_act[2, :9] = True
    out = [(_fake_enc([0, 1, 2, 0], Q=10, q_act=q_act), 8, None)]
    e = _fake_enc([0], V=9)
    e.v_owner[0, 7] = True
    out.append((e, 1, None))
    q_act = np.zeros((4, 12), bool)
    q_act[0, 2] = q_act[1, 5] = q_act[2, 11] = True
    out.append((_fake_enc([0, 3], Q=12, q_act=q_act), 2, np.array([[1, 2], [-1, -1]], np.int32)))
    out.append((_fake_enc(np.arange(8), Q=7), 8, None))
    for k in (16, 17):
        q_act = np.zeros((8, 8), bool)
        q_act.reshape(-1)[:k] = True
        out.append((_fake_enc(np.arange(8), Q=8, q_act=q_act), 8, None))
    rng = np.random.default_rng(7)
    for _ in range(6):
        G, S, Q, V = 6, 10, int(rng.integers(0, 20)), int(rng.integers(0, 20))
        e = _fake_enc(rng.integers(0, G, S), Q=Q, V=V,
                      q_act=rng.random((G, Q)) < 0.2, v_act=rng.random((G, V)) < 0.2)
        e.q_owner = rng.random((G, Q)) < 0.1
        e.v_owner = rng.random((G, V)) < 0.1
        lad = np.where(rng.random((S, 3)) < 0.5, rng.integers(0, G, (S, 3)), -1).astype(np.int32)
        out.append((e, 16, None))
        out.append((e, 16, lad))
    return out


@pytest.mark.parametrize("case", range(len(_fake_encs())))
def test_tables_and_gate_pinned(case):
    enc, Sp, lad = _fake_encs()[case]
    for a, b in zip(tencode.sparse_run_tables(enc, Sp, run_ladder=lad),
                    jencode.sparse_run_tables(enc, Sp, run_ladder=lad)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert tencode.constraint_density(enc) == jencode.constraint_density(enc)
    assert tencode.use_sparse_constraints(enc) is jencode.use_sparse_constraints(enc)


def test_gate_on_real_fleets_pinned():
    rng = random.Random(20)
    for pods in (_spread_fleet(rng, 6) + _filler(rng, 12), _affinity_fleet(rng, 8),
                 _spread_fleet(rng, 2) + _filler(rng, 10)):
        inp = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)
        je = jencode.encode(jencode.quantize_input(inp))
        te = tencode.encode(tencode.quantize_input(to_port(inp)))
        assert tencode.use_sparse_constraints(te) is jencode.use_sparse_constraints(je)
        for a, b in zip(tencode.sparse_run_tables(te, 16), jencode.sparse_run_tables(je, 16)):
            assert np.array_equal(a, b)


# -- raw outputs ------------------------------------------------------------------


def _mixed_fleet(seed=22):
    rng = random.Random(seed)
    pods = _spread_fleet(rng, 5) + _affinity_fleet(rng, 6) + _filler(rng, 16)
    nodes = [mknode(f"n{i}", ZONES[i % 3]) for i in range(5)]
    return SolverInput(pods=pods, nodes=nodes, nodepools=[pool()], zones=ZONES)


def _hostname_wide_fleet():
    """Nine hostname anti-affinity deployments (Q = 9 >= SPARSE_MIN_SIGS,
    each run touching one sig) and filler: "auto" gates it sparse, and the
    solve has no V-axis sig, so it runs the fast instance."""
    pods = []
    for a in range(9):
        for j in range(3):
            pods.append(mkpod(f"h{a}-{j}", cpu="500m", labels={"app": f"h{a}"},
                              affinity_terms=[PodAffinityTerm(
                                  label_selector={"app": f"h{a}"},
                                  topology_key=wk.HOSTNAME_LABEL, anti=True)]))
    pods += _filler(random.Random(5), 12)
    return SolverInput(pods=pods, nodes=[mknode("n0", ZONES[0])], nodepools=[pool()],
                       zones=ZONES)


KERNEL_FLEETS = {
    "spread": lambda: SolverInput(pods=_spread_fleet(random.Random(20), 6)
                                  + _filler(random.Random(20), 12),
                                  nodes=[], nodepools=[pool()], zones=ZONES),
    "mixed_nodes": _mixed_fleet,
    "hostname_wide": _hostname_wide_fleet,
}


def _captured_sparse(inp):
    """(run_q_idx, run_v_idx, host args, max_claims, zone_engine) of the
    checkpointed sparse dispatch TPUSolver(sparse="on") makes, as numpy."""
    (sq, sv, *args), kw = _capture(jffd, "ffd_solve_ckpt_sparse",
                                   lambda: TPUSolver(sparse="on").solve(inp))
    return (np.array(sq), np.array(sv), tuple(np.array(a) for a in args),
            kw["max_claims"], kw["zone_engine"])


def _equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _equal_output(j, t):
    tn = output_to_numpy(t)
    for k in ("take_e", "take_c", "leftover"):
        _equal(getattr(j, k), tn[k], k)
    for f in jffd.FFDState._fields:
        _equal(getattr(j.state, f), tn["state"][f], f)


def _equal_torch(a, b):
    for x, y in zip(a[:3] + tuple(a.state), b[:3] + tuple(b.state)):
        assert torch.equal(x, y)


def _t(x):
    return array_to_torch(x, "cpu")


@pytest.mark.parametrize("name", sorted(KERNEL_FLEETS))
def test_sparse_scan_matches_jax(name):
    sq, sv, args, M, zone = _captured_sparse(KERNEL_FLEETS[name]())
    targs = args_to_torch(args, "cpu")
    j = jffd.ffd_solve_sparse(sq, sv, *args, max_claims=M, zone_engine=zone)
    t = tffd.ffd_solve_sparse(_t(sq), _t(sv), *targs, max_claims=M, zone_engine=zone)
    _equal_output(j, t)
    _equal_torch(t, tffd.ffd_solve(*targs, max_claims=M, zone_engine=zone))
    if name == "hostname_wide":
        assert not zone and (sq >= 0).any()


@pytest.mark.parametrize("name", sorted(KERNEL_FLEETS))
def test_sparse_ckpt_and_resume_match_jax(name):
    """The checkpointed sparse scan and its ring, then the sparse resume from
    a JAX ring slot (its index tables the suffix rows), against the JAX
    twins; the resumed final carry is the cold one."""
    sq, sv, args, M, zone = _captured_sparse(KERNEL_FLEETS[name]())
    K, n = 2, 16
    kw = dict(max_claims=M, zone_engine=zone, ckpt_every=K, n_ckpt=n)
    jo, jr = jffd.ffd_solve_ckpt_sparse(sq, sv, *args, **kw)
    to, tr = tffd.ffd_solve_ckpt_sparse(_t(sq), _t(sv), *args_to_torch(args, "cpu"), **kw)
    _equal_output(jo, to)
    rn = ring_to_numpy(tr)
    for f in jffd.FFDState._fields:
        _equal(getattr(jr.states, f), rn["states"][f], f"ring.{f}")
    _equal(jr.prefix, rn["prefix"], "prefix")
    S = int((args[1] > 0).sum())
    k = 2 * ((S - 1) // 2)
    slot = k // K - 1
    jinit = jffd.FFDState(*(a[slot] for a in jr.states))
    Sp2 = 16 * -(-(S - k) // 16)
    suffix = [np.zeros(Sp2, np.int32) for _ in range(2)]
    idx = [np.full((Sp2, x.shape[1]), -1, np.int32) for x in (sq, sv)]
    for dst, src in zip(suffix + idx, (args[0], args[1], sq, sv)):
        dst[: S - k] = src[k:S]
    rkw = dict(kw, ckpt_every=K, n_ckpt=n)
    jso, _ = jffd.ffd_resume_sparse(jinit, *idx, *suffix, *args[2:], **rkw)
    tinit = tffd.FFDState(*(f[slot] for f in tr.states))
    before = state_to_numpy(tinit)
    tso, _ = tffd.ffd_resume_sparse(tinit, _t(idx[0]), _t(idx[1]),
                                    *args_to_torch(tuple(suffix) + args[2:], "cpu"), **rkw)
    _equal_output(jso, tso)
    tn = output_to_numpy(tso)
    for f in jffd.FFDState._fields:
        _equal(getattr(jo.state, f), tn["state"][f], f)
    for f, a in state_to_numpy(tinit).items():
        _equal(before[f], a, f)


def _perturbed(table: np.ndarray, width: int, n_cols: int, seed: int) -> np.ndarray:
    """Each row's entries in random slots of a wider row, -1 interleaved,
    plus extra distinct columns the row did not list (a superset)."""
    rng = np.random.default_rng(seed)
    out = np.full((table.shape[0], width), -1, np.int32)
    for s, row in enumerate(table):
        cols = [int(c) for c in row if c >= 0]
        extra = [c for c in rng.permutation(n_cols).tolist() if c not in cols][:2]
        vals = cols + extra
        slots = rng.choice(width, size=len(vals), replace=False)
        out[s, slots] = vals
    return out


@pytest.mark.parametrize("name", sorted(KERNEL_FLEETS))
def test_superset_and_interleaved_rows_decide_the_same(name):
    """Index rows with -1 anywhere and extra non-member columns (a superset)
    give the encode tables' outputs, in the JAX twin and in the port."""
    sq, sv, args, M, zone = _captured_sparse(KERNEL_FLEETS[name]())
    Q, V = args[tffd.ARG_INDEX["q_kind"]].shape[0], args[tffd.ARG_INDEX["v_kind"]].shape[0]
    pq = _perturbed(sq, sq.shape[1] + 8, Q, 1) if Q else sq
    pv = _perturbed(sv, sv.shape[1] + 8, V, 2) if V else sv
    targs = args_to_torch(args, "cpu")
    ref = tffd.ffd_solve_sparse(_t(sq), _t(sv), *targs, max_claims=M, zone_engine=zone)
    got = tffd.ffd_solve_sparse(_t(pq), _t(pv), *targs, max_claims=M, zone_engine=zone)
    _equal_torch(got, ref)
    _equal_output(jffd.ffd_solve_sparse(pq, pv, *args, max_claims=M, zone_engine=zone), got)


@pytest.mark.parametrize("empty", ["q", "v"])
def test_zero_width_axis_edges(empty):
    """Q = 0 (the spread fleet) and V = 0 (the hostname fleet) with
    all-padding index tables on the empty axis: nothing gathers from a
    zero-width table, and the outputs equal the dense scan's."""
    name = "spread" if empty == "q" else "hostname_wide"
    sq, sv, args, M, zone = _captured_sparse(KERNEL_FLEETS[name]())
    enc_q = int(np.asarray(args[tffd.ARG_INDEX["q_member"]]).any())
    enc_v = int(np.asarray(args[tffd.ARG_INDEX["v_member"]]).any()
                | np.asarray(args[tffd.ARG_INDEX["v_owner"]]).any())
    assert (enc_q, enc_v) == ((0, 1) if empty == "q" else (1, 0))
    assert ((sq if empty == "q" else sv) == -1).all()
    targs = args_to_torch(args, "cpu")
    got = tffd.ffd_solve_sparse(_t(sq), _t(sv), *targs, max_claims=M, zone_engine=zone)
    _equal_torch(got, tffd.ffd_solve(*targs, max_claims=M, zone_engine=zone))


def test_rings_resume_across_forms():
    """A dense ring resumes through the sparse resume and a sparse ring
    through the dense resume (ffd.py:2546-2549): both end at the cold
    carry."""
    sq, sv, args, M, zone = _captured_sparse(KERNEL_FLEETS["mixed_nodes"]())
    targs = args_to_torch(args, "cpu")
    kw = dict(max_claims=M, zone_engine=zone, ckpt_every=2, n_ckpt=16)
    dense_out, dense_ring = tffd.ffd_solve_ckpt(*targs, **kw)
    sparse_out, sparse_ring = tffd.ffd_solve_ckpt_sparse(_t(sq), _t(sv), *targs, **kw)
    _equal_torch(sparse_out, dense_out)
    S = int((args[1] > 0).sum())
    k = 2 * ((S - 1) // 2)
    slot = k // 2 - 1
    Sp2 = 16 * -(-(S - k) // 16)
    sg, sc = torch.zeros(Sp2, dtype=torch.int32), torch.zeros(Sp2, dtype=torch.int32)
    sg[: S - k], sc[: S - k] = targs[0][k:S], targs[1][k:S]
    q2 = torch.full((Sp2, sq.shape[1]), -1, dtype=torch.int32)
    v2 = torch.full((Sp2, sv.shape[1]), -1, dtype=torch.int32)
    q2[: S - k], v2[: S - k] = _t(sq)[k:S], _t(sv)[k:S]
    from_dense = tffd.FFDState(*(f[slot] for f in dense_ring.states))
    from_sparse = tffd.FFDState(*(f[slot] for f in sparse_ring.states))
    a, _ = tffd.ffd_resume_sparse(from_dense, q2, v2, sg, sc, *targs[2:], **kw)
    b, _ = tffd.ffd_resume(from_sparse, sg, sc, *targs[2:], **kw)
    for x, y, z in zip(a.state, b.state, dense_out.state):
        assert torch.equal(x, z) and torch.equal(y, z)


LADDER_FLEETS = ("ladder_schedule_anyway_spreads", "ladder_mixed_preference_kinds_one_solve",
                 "anti_weighted_hostname_anti_on_device")


@pytest.mark.parametrize("name", LADDER_FLEETS)
def test_sparse_ladder_matches_jax(name):
    """The ladder's sparse twin on the rung table and union index tables
    TPUSolver(sparse="on") dispatches, against the JAX twin and the dense
    plain ladder."""
    (lad, sq, sv, *args), kw = _capture(jffd, "ffd_solve_ladder_sparse",
                                        lambda: TPUSolver(sparse="on").solve(RELAX_FLEETS[name]()))
    lad, sq, sv = np.array(lad), np.array(sq), np.array(sv)
    args = tuple(np.array(a) for a in args)
    M, zone = kw["max_claims"], kw["zone_engine"]
    j = jffd.ffd_solve_ladder_sparse(lad, sq, sv, *args, max_claims=M, zone_engine=zone)
    targs = args_to_torch(args, "cpu")
    t = tffd.ffd_solve_ladder_sparse(_t(lad), _t(sq), _t(sv), *targs, max_claims=M,
                                     zone_engine=zone)
    _equal_output(j, t)
    d = tffd.ffd_solve_ladder(_t(lad), *targs, max_claims=M, zone_engine=zone)
    _equal_torch(t, d)
    assert int(t.attempts) == int(d.attempts)


# -- solver level ---------------------------------------------------------------------


SOLVER_FLEETS = {
    "spread": KERNEL_FLEETS["spread"],
    "affinity": lambda: SolverInput(pods=_affinity_fleet(random.Random(21), 8)
                                    + _filler(random.Random(21), 12),
                                    nodes=[], nodepools=[pool()], zones=ZONES),
    "mixed_nodes": _mixed_fleet,
    "hostname_wide": _hostname_wide_fleet,
    "hostname_q_kinds": lambda: build(CASES["hostname_q_kinds"], "karpenter_tpu"),
    "preference_ladder": RELAX_FLEETS["ladder_mixed_preference_kinds_one_solve"],
}


@pytest.mark.parametrize("sparse", ["on", "auto", "off"])
@pytest.mark.parametrize("name", sorted(SOLVER_FLEETS))
def test_solver_matches_tpu_solver(name, sparse):
    inp = SOLVER_FLEETS[name]()
    tpu = TPUSolver(sparse=sparse)
    want = as_data(tpu.solve(inp))
    port = TorchSolver(device="cpu", sparse=sparse)
    assert as_data(port.solve(to_port(inp))) == want
    for k in ("sparse_dispatches", "ladder_solves", "device_solves"):
        assert port.stats[k] == tpu.stats[k], (k, port.stats, tpu.stats)
    if sparse == "on":
        assert port.stats["sparse_dispatches"] == 1
    if sparse == "off":
        assert port.stats["sparse_dispatches"] == 0
    if name == "hostname_wide" and sparse == "auto":
        assert port.stats["sparse_dispatches"] == 1


def test_bad_sparse_knob_raises():
    for bad in ("sometimes", "", None, True):
        with pytest.raises(ValueError):
            TorchSolver(device="cpu", sparse=bad)


_LEDGER = ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs")


def _spread_tail_fleet(extra: int):
    """Nine spread deployments of distinct sizes (V = 9: "auto" gates
    sparse); `extra` more replicas of the smallest (the run that sorts
    last): a tail change."""
    pods = []
    for a in range(9):
        tsc = TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL,
                                       label_selector={"app": f"s{a}"})
        for j in range(4 + (extra if a == 8 else 0)):
            pods.append(mkpod(f"s{a}-{j}", cpu=f"{1000 - 90 * a}m", mem="1Gi",
                              labels={"app": f"s{a}"}, topology_spread=[tsc]))
    for i in range(8):
        pods.append(mkpod(f"f{i}", cpu="2", mem="2Gi"))
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def test_ledger_matches_jax_over_cold_repeat_and_resume():
    """Cold, exact repeat and tail resume under the sparse gate: the port's
    per-solve ledger, stale sets, resume stats and sparse dispatches equal
    TPUSolver's; the resume uploads the two suffix index arrays (Sp2 x Kq
    and Sp2 x Kv int32, two messages) beside the suffix run arrays."""
    port = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
    tpu = TPUSolver(ckpt_every=2, ckpt_slots=16)
    seq = [_spread_tail_fleet(0), _spread_tail_fleet(0), _spread_tail_fleet(3)]
    for i, inp in enumerate(seq):
        assert as_data(port.solve(to_port(inp))) == as_data(tpu.solve(inp)), i
        for k in _LEDGER:
            assert port.ledger.solve[k] == tpu.ledger.solve[k], (i, k, port.ledger.solve,
                                                                  tpu.ledger.solve)
        assert port.arena.last_stale == tpu.arena.last_stale, i
        for k in ("resume_solves", "resume_runs_skipped", "sparse_dispatches"):
            assert port.stats[k] == tpu.stats[k], (i, k)
    assert port.stats["sparse_dispatches"] == 3 and port.stats["resume_solves"] == 1
    assert port.ledger.outcomes["exact_hit"] == 1
    assert port.ledger.solve["h2d_msgs"] == 5  # run entry, 2 suffix runs, 2 suffix rows
    assert port.arena._sparse
    port.invalidate_arena()
    assert not port.arena._sparse


def test_sparse_tables_evict_with_their_bucket():
    """The sparse residency class is counted under the budget and dropped
    with its bucket."""
    port = TorchSolver(device="cpu")
    port.solve(to_port(_spread_tail_fleet(0)))
    key = next(iter(port.arena._buckets))
    assert port.arena._bytes[key]["sparse"] == 2 * 16 * 8 * 4
    port.arena._evict_bucket(key)
    assert not port.arena._sparse
