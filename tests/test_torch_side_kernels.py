"""The explain pack (K12) and the run-table edit (K14) of the port: the
rules and tables their launches take, and their plain versions against the
JAX package, on the CPU.

- K12's team rule (ffd.explain_team), the local team's shared layout and
  the grid's scratch against the constants and the expressions of
  csrc/class_kernels.cu, at the rule's boundaries and at the main path's
  shapes (class_contended's cold solve, surge_e2e).
- `explain_pack_plain` (the plain version K12 is held to on the card)
  against the JAX `explain_pack` on chip_smoke.explain_crafted_tables: a
  group with no runs, runs at or past g_count, e_count < Ep, g_count < Gp,
  Ep past one staged chunk, top_k past Ep, int32 wrap of the placed sums
  and of the usage, rejections spread thin or only past the first 128
  nodes with top_k 100, no nodes.
- K14's parameter table (ffd.event_param_table, pure Python): its layout,
  K = 0, the limit and one row past it, and EVENT_PARAM_ROWS against the
  launcher's EV_PARAM_ROWS and the 4 KB parameter space.
- `ffd_apply_events_plain`: its pair is the two rows of one [2, Sp]
  tensor, equal to the JAX `ffd_apply_events`, from tensor and from host
  rows, the inputs unwritten.
- A staged solve (stream_run_events) of TorchSolver(device="cpu") against
  TPUSolver's: decisions and the ledger's h2d bytes and messages equal, the
  resident run tables the two rows of one allocation, counted once by
  `block_bytes`.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from karpenter_tpu_torch.solver.encode import encode, quantize_input
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_jax_release import release_if_crowded
from tests.test_torch_relax import to_port
from tests.test_torch_solver import as_data

torch.set_num_threads(1)

CSRC = pathlib.Path(tffd.__file__).resolve().parents[2] / "csrc"


@pytest.fixture(autouse=True)
def _release_jax():
    yield
    release_if_crowded()


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr (?:long long|int) {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


# ------------------------------------------------------------------ K12


def test_explain_team_constants_pinned_to_the_launcher():
    src = (CSRC / "class_kernels.cu").read_text()
    assert _constant(src, "EXPLAIN_LOCAL") == tffd.EXPLAIN_LOCAL
    assert _constant(src, "EXPLAIN_GRID") == tffd.EXPLAIN_GRID
    assert _constant(src, "EXPLAIN_LOCAL_CELLS") == tffd.EXPLAIN_LOCAL_CELLS
    assert _constant(src, "EXPLAIN_LOCAL_GROUPS") == tffd.EXPLAIN_LOCAL_GROUPS
    assert _constant(src, "XS_WORDS") == tffd.EXPLAIN_SMEM_WORDS
    assert _constant(src, "XT") // 32 == tffd.EXPLAIN_TILE_GROUPS
    assert "constexpr int XW = XT / 32;" in src
    assert ("(long long)Sp * Ep <= EXPLAIN_LOCAL_CELLS && Gp <= EXPLAIN_LOCAL_GROUPS &&\n"
            "                 explain_local_words(Sp, Ep, Gp, R) <= XS_WORDS") in src
    assert "const long long cols = Ep <= 32 ? 32 : (Ep + 31LL) / 32 * 32;" in src
    assert "return (R + 2 + XW) * cols + Sp + (long long)Gp * R;" in src
    assert "return (long long)R * Ep + 2LL * (Gp + 1) + Sp;" in src
    assert _constant(src, "MAX_R") == tffd.MAX_R


@pytest.mark.parametrize("shape,team", [
    ((64, 64, 64, 3), 1), ((256, 64, 1, 3), 1), ((257, 64, 1, 3), 2), ((1, 64, 256, 3), 1),
    ((1, 64, 257, 3), 2), ((1, 448, 1, 16), 1), ((1, 449, 1, 16), 2), ((0, 0, 1, 0), 1),
    ((4096, 1, 4096, 3), 2), ((32, 224, 32, 3), 1), ((1008, 2016, 1024, 3), 2)])
def test_explain_team_rule(shape, team):
    """The rule at its boundaries (Sp * Ep at most 16 384, Gp at most 256,
    the local layout within 12 288 shared words: at R 16 and Sp 1 that is Ep
    448, 26 rows of 448 columns, against 449's 480) and at surge_e2e's and
    class_contended's shapes."""
    assert tffd.explain_team(*shape) == team
    assert team in tffd.explain_teams(*shape)


def test_explain_local_words():
    # (R + 2) staged rows and a tile's 8 placed rows over 32-column multiples
    # (32 at least), the staged run_group and group_req
    assert tffd.explain_local_words(32, 224, 32, 3) == 13 * 224 + 32 + 32 * 3
    assert tffd.explain_local_words(0, 0, 1, 0) == 10 * 32
    assert tffd.explain_local_words(1, 449, 1, 16) == 26 * 480 + 1 + 16
    # class_contended's cold solve: the local layout does not fit, only the grid can run
    assert tffd.explain_teams(1008, 2016, 1024, 3) == (tffd.EXPLAIN_GRID,)
    assert tffd.explain_teams(32, 224, 32, 3) == (tffd.EXPLAIN_LOCAL, tffd.EXPLAIN_GRID)


def test_explain_scratch_words():
    # ff [R, Ep], off and the sort's counters [Gp + 1] each, ids [Sp]
    assert tffd.explain_scratch_words(1008, 2016, 1024, 3) == 3 * 2016 + 2 * 1025 + 1008
    assert tffd.explain_scratch_words(0, 0, 1, 0) == 4


@pytest.mark.parametrize("name", sorted(cs.explain_crafted_tables()))
def test_explain_plain_matches_jax_on_crafted_tables(name):
    host, k = cs.explain_crafted_tables()[name]
    arrays, (e_count, g_count) = host[:11], host[11:]
    want = np.asarray(jffd.explain_pack(*arrays, np.int32(e_count), np.int32(g_count), top_k=k))
    got = tffd.explain_pack(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
                            e_count, g_count, top_k=k).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_crafted_tables_reach_their_cases():
    """The crafted tables hold what their names claim: a group with no runs,
    runs at or past g_count, wrapped placed sums, top_k past Ep, an Ep past
    one staged chunk at R 16, rejections only past the first 128 nodes with
    top_k 100, no nodes."""
    t = cs.explain_crafted_tables()
    host, _ = t["seeded"]
    assert not np.isin([5, 13], host[1]).any() and (host[1] >= host[12]).any()
    assert host[11] < host[0].shape[1] and host[12] < host[2].shape[0]
    host, k = t["odd_ep_top_k_past"]
    assert k > host[0].shape[1] and host[0].shape[1] % 32
    host, _ = t["two_chunks_r16"]
    Ep, R = host[0].shape[1], host[2].shape[1]
    assert R == 16 and Ep > (12288 // (R + 2)) // 32 * 32 and Ep % 32
    host, _ = t["wrap"]
    g0 = host[1] == 0
    sums = host[0][g0].astype(np.int64).sum(axis=0)
    assert sums[5] == 1 << 31 and sums[7] == (1 << 32) + 2
    assert t["no_nodes"][0][0].shape[1] == 0
    host, k = t["kept_past_xk"]
    assert k == 100 and host[4][:, :128].all() and not host[4][:, 128:].any()


# ------------------------------------------------------------------ K14


def test_event_param_table_layout():
    ev = np.arange(12, dtype=np.int32).reshape(4, 3)
    t = tffd.event_param_table(32, ev)
    assert t.dtype == np.int32 and t.tolist() == [32, 4] + list(range(12))
    assert tffd.event_param_table(7, np.zeros((0, 3), np.int32)).tolist() == [7, 0]
    full = np.ones((tffd.EVENT_PARAM_ROWS, 3), np.int32)
    assert tffd.event_param_table(4096, full).shape == (2 + 3 * tffd.EVENT_PARAM_ROWS,)
    with pytest.raises(ValueError):
        tffd.event_param_table(4096, np.ones((tffd.EVENT_PARAM_ROWS + 1, 3), np.int32))


def test_event_param_rows_pinned_to_the_launcher():
    src = (CSRC / "arena_kernels.cu").read_text()
    assert _constant(src, "EV_PARAM_ROWS") == tffd.EVENT_PARAM_ROWS
    # the table, three pointers, a pointer and two ints in the 4 KB parameter space
    assert 4 * 3 * tffd.EVENT_PARAM_ROWS + 4 * 8 + 2 * 4 <= 4096


@pytest.mark.parametrize("Sp,K", [(32, 0), (32, 8), (4096, 255), (4096, 256), (4096, 257),
                                  (4096, 1024)])
def test_apply_events_plain_is_one_allocation_equal_to_jax(Sp, K):
    rg, rc, ev = cs.event_rows(Sp * 3 + K, Sp, K)
    dropped = ev.copy()
    dropped[dropped[:, 0] < 0, 0] = Sp + 7  # the reference wraps negatives (ROADMAP §C.9)
    jrg, jrc = (np.asarray(x) for x in jffd.ffd_apply_events(rg, rc, dropped))
    trg_in, trc_in = torch.from_numpy(rg.copy()), torch.from_numpy(rc.copy())
    for rows in (ev, torch.from_numpy(ev), dropped):
        grg, grc = tffd.ffd_apply_events(trg_in, trc_in, rows)
        assert grg.dtype == grc.dtype == torch.int32
        assert grg.untyped_storage().data_ptr() == grc.untyped_storage().data_ptr()
        assert (grg.storage_offset(), grc.storage_offset()) == (0, Sp)
        assert grg.untyped_storage().nbytes() == 2 * Sp * 4
        np.testing.assert_array_equal(grg.numpy(), jrg)
        np.testing.assert_array_equal(grc.numpy(), jrc)
    np.testing.assert_array_equal(trg_in.numpy(), rg)
    np.testing.assert_array_equal(trc_in.numpy(), rc)


def _fleet():
    pods = [mkpod(f"sk{i}", cpu=("250m", "500m", "750m", "1")[i % 4]) for i in range(24)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def test_staged_solve_accounting_matches_jax():
    """A staged count edit: the decisions and the ledger of every solve equal
    TPUSolver's with the same flag; the stage's upload is the padded 8-row
    table (96 B, one message) as before; the resident run tables are the
    two rows of K14's one allocation and block_bytes counts it once."""
    inp = _fleet()
    seq = [inp, dataclasses.replace(inp, pods=inp.pods[:-1]),
           dataclasses.replace(inp, pods=inp.pods[:-2]), inp]
    j = jbackend.TPUSolver(max_claims=256)
    t = tbackend.TorchSolver(device="cpu", max_claims=256)
    j.stream_run_events = t.stream_run_events = True
    fields = ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs")
    for i, x in enumerate(seq):
        rj, rt = j.solve(x), t.solve(to_port(x))
        assert as_data(rt) == as_data(rj), i
        assert {k: t.ledger.solve[k] for k in fields} == {k: j.ledger.solve[k] for k in fields}, i
        if i == 1:
            assert t.ledger.solve["h2d_bytes"] == 8 * tffd.EVENT_ENTRY_WORDS * 4
            assert t.ledger.solve["h2d_msgs"] == 1
    assert t.arena.stats["event_batches"] == 3 == j.arena.stats["event_batches"]
    enc = encode(quantize_input(to_port(seq[-1])))
    host_args = tbackend.host_kernel_args(enc, t._bucket)[0]
    key = t.arena.bucket_key(host_args, ns=enc.tenant_id)
    dev = t.arena._buckets[key][0]
    Sp = int(host_args[0].shape[0])
    assert dev[0].untyped_storage().data_ptr() == dev[1].untyped_storage().data_ptr()
    assert dev[0].untyped_storage().nbytes() == 2 * Sp * 4
    blocks = sum(t.arena._blocks.get(key, {}).values())
    assert t.arena.block_bytes(key) == blocks + 2 * Sp * 4
    np.testing.assert_array_equal(dev[0].numpy(), host_args[0])
    np.testing.assert_array_equal(dev[1].numpy(), host_args[1])
