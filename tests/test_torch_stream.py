"""Streaming run-table staging of the port against the JAX package.

- `ffd_apply_events` (K14's plain version) against the JAX
  `ffd_apply_events` on seeded event batches at Sp in {32, 4 096} and K in
  {0, 8, 1 024}, pad rows (EVENT_PAD_POS) and positions -1, Sp and Sp + 7
  included: exact equality, the inputs untouched. Positions inside [0, Sp)
  are unique, as `run_table_events` makes them (the reference's scatter has
  no defined winner for duplicates). Both drop the positive positions past
  Sp. A negative position is where they part: the port drops it, as the
  reference documents (ffd.py:314-316), but the reference's
  `.at[pos].set(mode="drop")` wraps it as a NumPy index first, so
  EVENT_PAD_POS = -1 writes run Sp - 1 (ROADMAP §C.9). The JAX side is
  therefore fed each negative position moved past Sp, which its scatter
  does drop, and the port is held equal on both forms;
  `test_reference_wraps_negative_positions` pins the difference, and
  `test_stage_with_a_full_run_axis` shows it on a solve whose run axis has
  no padding (S == Sp), where the reference's staged solve fails and the
  port's decides as the unstaged one.
- `encode_cache.run_table_events` against the JAX one, its None returns
  (shape change, more edits than max_events) and the empty batch included.
- `TorchSolver(device="cpu")` with `stream_run_events = True` against
  `TPUSolver` with the same flag on tests/test_streaming_solve.py's
  TestStagedRunEvents fleets: decisions, event_stage_hits / misses, the
  arena's event_batches / event_edits, the transfer ledger per solve, the
  resident run tables equal to the host encode after a hit, the decline on
  an unknown diff base and after invalidate_arena().
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode_cache as jec
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu.utils.resources import Resources
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver import encode_cache as tec
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from karpenter_tpu_torch.solver.encode import encode, quantize_input
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_relax import to_port
from tests.test_torch_solver import as_data

torch.set_num_threads(1)


def _events(seed: int, Sp: int, K: int) -> np.ndarray:
    """K int32 (pos, gid, cnt) rows: unique in-range positions, then the
    out-of-range positions -1, Sp, Sp + 7 and EVENT_PAD_POS pad rows."""
    rng = np.random.default_rng(seed)
    out_of_range = [-1, Sp, Sp + 7]
    n_in = min(max(0, K - len(out_of_range)), Sp)
    pos = list(rng.choice(Sp, size=n_in, replace=False))
    pos += out_of_range[: max(0, K - n_in)]
    pos += [jffd.EVENT_PAD_POS] * (K - len(pos))
    ev = np.empty((K, 3), dtype=np.int32)
    ev[:, 0] = np.asarray(pos, dtype=np.int64)[rng.permutation(K)] if K else []
    ev[:, 1] = rng.integers(0, 1 << 20, K)
    ev[:, 2] = rng.integers(-5, 1 << 16, K)
    return ev


@pytest.mark.parametrize("Sp", [32, 4096])
@pytest.mark.parametrize("K", [0, 8, 1024])
def test_apply_events_plain_matches_jax(Sp, K):
    rng = np.random.default_rng(Sp + K)
    rg = rng.integers(0, 4000, Sp).astype(np.int32)
    rc = rng.integers(0, 1 << 15, Sp).astype(np.int32)
    ev = _events(Sp * 7 + K, Sp, K)
    dropped = ev.copy()
    dropped[dropped[:, 0] < 0, 0] = Sp + 7
    jrg, jrc = jffd.ffd_apply_events(rg, rc, dropped)
    trg_in, trc_in = torch.from_numpy(rg.copy()), torch.from_numpy(rc.copy())
    for batch in (ev, dropped):
        trg, trc = tffd.ffd_apply_events(trg_in, trc_in, torch.from_numpy(batch))
        assert trg.dtype == trc.dtype == torch.int32
        np.testing.assert_array_equal(trg.numpy(), np.asarray(jrg))
        np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    # the inputs are not written (the reference's jit does not donate)
    np.testing.assert_array_equal(trg_in.numpy(), rg)
    np.testing.assert_array_equal(trc_in.numpy(), rc)
    in_range = int(((ev[:, 0] >= 0) & (ev[:, 0] < Sp)).sum()) if K else 0
    assert in_range == min(max(0, K - 3), Sp)


def test_reference_wraps_negative_positions():
    """The reference writes an EVENT_PAD_POS row into run Sp - 1 (and -3
    into Sp - 3; -9 past an 8-run axis drops); the port drops every
    position outside [0, Sp), as the reference's docstring says."""
    rg = np.arange(8, dtype=np.int32)
    rc = np.arange(8, dtype=np.int32) + 10
    ev = np.array([[jffd.EVENT_PAD_POS, 0, 0], [-3, 9, 9], [-9, 7, 7], [8, 5, 5]], np.int32)
    jrg, jrc = (np.asarray(x) for x in jffd.ffd_apply_events(rg, rc, ev))
    assert jrg.tolist() == [0, 1, 2, 3, 4, 9, 6, 0] and jrc.tolist()[5:] == [9, 16, 0]
    trg, trc = tffd.ffd_apply_events(torch.from_numpy(rg), torch.from_numpy(rc),
                                     torch.from_numpy(ev))
    assert trg.tolist() == rg.tolist() and trc.tolist() == rc.tolist()


@pytest.mark.parametrize("seed", range(4))
def test_run_table_events_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = 64
    prev_rg = rng.integers(0, 30, S).astype(np.int32)
    prev_rc = rng.integers(1, 100, S).astype(np.int32)
    rg, rc = prev_rg.copy(), prev_rc.copy()
    idx = rng.choice(S, size=3 + seed, replace=False)
    rg[idx[:2]] += 1
    rc[idx[2:]] += 7
    for mx in (0, 4, 16):
        j = jec.run_table_events(prev_rg, prev_rc, rg, rc, max_events=mx)
        t = tec.run_table_events(prev_rg, prev_rc, rg, rc, max_events=mx)
        if j is None:
            assert t is None and mx and len(idx) > mx
        else:
            assert t.dtype == j.dtype == np.int32
            np.testing.assert_array_equal(t, j)
    for f in (jec, tec):  # no change: an empty [0, 3] batch
        e = f.run_table_events(prev_rg, prev_rc, prev_rg, prev_rc)
        assert e.shape == (0, 3) and e.dtype == np.int32
    grown = np.concatenate([rg, rg[:16]])
    assert jec.run_table_events(prev_rg, prev_rc, grown, rc) is None
    assert tec.run_table_events(prev_rg, prev_rc, grown, rc) is None


def test_event_constants_pinned():
    assert (tffd.EVENT_ENTRY_WORDS, tffd.EVENT_PAD_POS) == (
        jffd.EVENT_ENTRY_WORDS, jffd.EVENT_PAD_POS)


# --------------------------------------------------------------- backend


def _fleet():
    """TestStagedRunEvents's fleet (24 pods over four sizes) and its
    variant with one pod's spec changed: same shape bucket, different run
    tables."""
    pods = [mkpod(f"p{i}", cpu=("250m", "500m", "750m", "1")[i % 4]) for i in range(24)]
    inp1 = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)
    pods2 = list(pods)
    pods2[3] = dataclasses.replace(pods[3], requests=Resources.parse({"cpu": "1", "memory": "1Gi"}))
    inp2 = SolverInput(pods=pods2, nodes=[], nodepools=[pool()], zones=ZONES)
    return inp1, inp2


def _drop_one(inp: SolverInput, k: int) -> SolverInput:
    """The fleet with its last k pods gone: one run's count moves (a
    single run-table edit while the run list keeps its shape)."""
    return dataclasses.replace(inp, pods=inp.pods[: len(inp.pods) - k])


def _pair(streamed: bool):
    j = jbackend.TPUSolver(max_claims=256)
    t = tbackend.TorchSolver(device="cpu", max_claims=256)
    j.stream_run_events = t.stream_run_events = streamed
    return j, t


def _ledger(s, which="solve"):
    """The port ledger's fields of either package's ledger."""
    d = getattr(s.ledger, which)
    return {k: d[k] for k in ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs")}


def _stage_view(s):
    return (s.stats["event_stage_hits"], s.stats["event_stage_misses"],
            s.arena.stats["event_batches"], s.arena.stats["event_edits"])


def _resident_runs(solver, inp):
    """The bucket's resident run tables and the host encode's."""
    enc = encode(quantize_input(inp))
    host_args, _dims, _prov = tbackend.host_kernel_args(enc, solver._bucket)
    dev, _tags = solver.arena._buckets[solver.arena.bucket_key(host_args, ns=enc.tenant_id)]
    return (dev[0].numpy(), dev[1].numpy()), (host_args[0], host_args[1])


def test_staged_solves_match_jax_and_the_unstaged_solver():
    """A sequence that stages (a one-spec change, count drops, a repeat,
    the base again) decides as TPUSolver with the same flag and as an
    unstaged port solver; the stage counters, the arena's event counters
    and the ledger of every solve equal the JAX backend's; after each hit
    the resident run tables equal the host encode."""
    inp1, inp2 = _fleet()
    seq = [inp1, inp2, inp1, _drop_one(inp1, 1), _drop_one(inp1, 2), inp1, inp1, inp2]
    j, t = _pair(True)
    _, ctl = _pair(False)
    hits = 0
    for inp in seq:
        rj = j.solve(inp)
        rt = t.solve(to_port(inp))
        assert as_data(rt) == as_data(rj)
        assert as_data(ctl.solve(to_port(inp))) == as_data(rt)
        assert _stage_view(t) == _stage_view(j)
        assert _ledger(t) == _ledger(j), (t.ledger.solve, j.ledger.solve)
        if t.stats["event_stage_hits"] > hits:
            hits = t.stats["event_stage_hits"]
            (drg, drc), (hrg, hrc) = _resident_runs(t, to_port(inp))
            np.testing.assert_array_equal(drg, hrg)
            np.testing.assert_array_equal(drc, hrc)
    assert t.stats["event_stage_hits"] >= 4 and t.arena.stats["event_batches"] >= 3, t.stats
    assert t.stats["event_stage_misses"] == 1  # the cold first solve
    assert _ledger(t, "total") == _ledger(j, "total")
    assert ctl.stats["event_stage_hits"] == ctl.stats["event_stage_misses"] == 0


def test_stage_ships_fewer_run_bytes_than_adopt():
    """A staged count edit uploads one padded 8-row triplet table (96 B)
    where the unstaged solver re-uploads the run-count entry."""
    inp1, _ = _fleet()
    _, t = _pair(True)
    _, ctl = _pair(False)
    for s in (t, ctl):
        s.solve(to_port(inp1))
        s.solve(to_port(_drop_one(inp1, 1)))
    assert t.arena.stats["event_batches"] == 1 and t.arena.stats["event_edits"] == 1
    assert t.ledger.solve["h2d_bytes"] == 8 * tffd.EVENT_ENTRY_WORDS * 4
    assert t.ledger.solve["h2d_msgs"] == 1
    assert ctl.ledger.solve["h2d_bytes"] > 0 and ctl.ledger.solve["h2d_msgs"] == 1


def test_stage_declines_on_unknown_diff_base():
    """First sight of a bucket (no recorded host pair) declines, as the
    JAX backend does, and adopt pays the normal upload."""
    inp = SolverInput(pods=[mkpod("p0"), mkpod("p1")], nodes=[], nodepools=[pool()],
                      zones=ZONES)
    j, t = _pair(True)
    assert as_data(t.solve(to_port(inp))) == as_data(j.solve(inp))
    assert _stage_view(t) == _stage_view(j) == (0, 1, 0, 0)
    assert _ledger(t) == _ledger(j)


def test_stage_declines_after_invalidate():
    """invalidate_arena() drops the recorded host pair with the resident
    tensors: the next solve declines and uploads whole, the one after it
    stages again."""
    inp1, inp2 = _fleet()
    j, t = _pair(True)
    for s, conv in ((j, lambda x: x), (t, to_port)):
        s.solve(conv(inp1))
        s.solve(conv(inp2))
        s.invalidate_arena()
        s.solve(conv(inp1))
        assert s.stats["event_stage_misses"] == 2, s.stats
        s.solve(conv(inp2))
    assert _stage_view(t) == _stage_view(j)
    assert t.stats["event_stage_hits"] == 2
    assert _ledger(t, "total") == _ledger(j, "total")


def test_stage_with_a_full_run_axis():
    """16 pod specs fill the 16-run axis (S == Sp: no padding run). Dropping
    one pod edits one run; the stage pads the edit to 8 rows with
    EVENT_PAD_POS. The port's scatter drops the pad rows and decides as the
    unstaged solvers of both packages; the reference's wraps them onto the
    last run, whose pods the device then never sees, and its decode fails
    (ROADMAP §C.9)."""
    cpus = [f"{100 * (i + 1)}m" for i in range(16)]
    pods = [mkpod(f"p{i}", cpu=cpus[i % 16]) for i in range(64)]
    inp1 = SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)
    inp2 = _drop_one(inp1, 1)
    j, t = _pair(True)
    jctl, tctl = _pair(False)
    for s, conv in ((j, lambda x: x), (t, to_port), (jctl, lambda x: x), (tctl, to_port)):
        s.solve(conv(inp1))
    want = as_data(jctl.solve(inp2))
    assert as_data(tctl.solve(to_port(inp2))) == want
    assert as_data(t.solve(to_port(inp2))) == want
    assert t.stats["event_stage_hits"] == 1 and t.arena.stats["event_edits"] == 1
    (drg, drc), (hrg, hrc) = _resident_runs(t, to_port(inp2))
    assert len(hrg) == 16 and hrc[-1] > 0
    np.testing.assert_array_equal(drg, hrg)
    np.testing.assert_array_equal(drc, hrc)
    with pytest.raises(IndexError):
        j.solve(inp2)
