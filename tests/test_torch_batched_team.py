"""The batched consolidation scan (K4) on the cluster team, on the CPU.

K4 (csrc/ffd_kernels.cu ffd_batched_kernel, built as
csrc/ffd_batched_kernels.cu) runs each candidate-subset row on K1's cluster
team, the team chosen at launch from the rows B and what the card holds
(launch_batched): one cluster of CL CTAs a row where the card holds all B
such clusters at once, else one CTA a row with several rows an SM. The
kernel runs only on the card (chip_smoke.py phase 2b holds it against its
plain version there, on every team); here:

- solver/cuda/consolidate.py batched_team, the rule the wrapper applies: on
  the H100's fit table (16 -> 7, 8 -> 15, 4 -> 30, 2 -> 66 clusters at once,
  tests/test_torch_lanes_cluster.py's, and 264 CTAs of the many-rows
  instance: 2 a SM of 132), on a card that refuses the non-portable 16, and
  past every cluster fit (the many-rows team); B < 1 and a card that holds
  no team raise.
- a row's scratch on both teams: the scan's shared rows, its CL CTAs' own
  rows, then the take rows and the removed-node mask, no two pieces
  overlapping (ffd.batch_scratch_words, batch_take_offset).
- the wrapper hands the launcher that scratch and its dims and the team it
  picked or was forced onto, always (on CPU tensors: a recording launcher
  stands in for the library, and the argument check skips its device
  test); a team outside 1, 2, 4, 8, 16 raises before any launch.
- batched_ffd_plain (K4's plain version) against the JAX `_batched_ffd` at
  B 8, 16 and 40, fast and zoned, M 2 and 16, saturating rows included.

Every output is an integer: the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.solver.tpu import consolidate as jcons
from karpenter_tpu_torch.solver.convert import args_to_torch
from karpenter_tpu_torch.solver.cuda import build as tbuild
from karpenter_tpu_torch.solver.cuda import consolidate as tcons
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_consolidate import assert_outputs_equal, fleet, universe_args
from tests.test_torch_jax_release import release_if_crowded
from tests.test_torch_lanes_cluster import H100_FITS

torch.set_num_threads(2)

# the H100's teams (an NVIDIA H100 80GB HBM3, 700.00 W: the clusters of the
# lanes instances, PERF.md §6; the many-rows instance 2 CTAs a SM of 132)
H100_TEAMS = {**H100_FITS, 1: 2 * 132}


@pytest.fixture(scope="module", autouse=True)
def _release_jax():
    yield
    release_if_crowded()


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("B,cl", [(1, 16), (3, 16), (7, 16), (8, 8), (15, 8), (16, 4), (30, 4),
                                  (31, 2), (66, 2), (67, 1), (264, 1), (512, 1), (5_000, 1)])
def test_batched_team_on_the_h100(B, cl):
    """The largest cluster that holds all B rows at once; past fit(2) one
    CTA a row, past what the card holds at once in waves."""
    assert tcons.batched_team(B, H100_TEAMS) == cl


@pytest.mark.parametrize("B,cl", [(1, 8), (8, 8), (15, 8), (16, 4), (66, 2), (67, 1), (512, 1)])
def test_batched_team_without_the_non_portable_size(B, cl):
    """A card that refuses 16 CTAs a cluster (fit 0, or no entry) starts at 8."""
    assert tcons.batched_team(B, {**H100_TEAMS, 16: 0}) == cl
    assert tcons.batched_team(B, {k: v for k, v in H100_TEAMS.items() if k != 16}) == cl


def test_batched_team_past_every_cluster_fit():
    """Past every cluster size the launch takes one CTA a row, however few
    the card holds at once; a card that holds no team, or B < 1, raises."""
    assert tcons.batched_team(100, {16: 1, 8: 2, 4: 4, 2: 8, 1: 1}) == 1
    assert tcons.batched_team(2, {16: 2, 8: 0, 4: 0, 2: 0, 1: 0}) == 16
    with pytest.raises(ValueError, match="no team"):
        tcons.batched_team(9, {16: 0, 8: 0, 4: 0, 2: 8, 1: 0})
    with pytest.raises(ValueError, match="no team"):
        tcons.batched_team(3, {16: 2, 8: 0, 4: 0, 2: 0, 1: 0})
    with pytest.raises(ValueError, match="no team"):
        tcons.batched_team(1, {16: 0, 8: 0, 4: 0, 2: 0})
    with pytest.raises(ValueError, match="B=0"):
        tcons.batched_team(0, H100_TEAMS)
    assert tcons.BATCH_CLUSTERS == (16, 8, 4, 2) == tffd.LANE_CLUSTERS
    assert tcons.batched_fits("cpu", False, 0) is None


# ------------------------------------------------------------- the scratch


@pytest.mark.parametrize("cl", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("E,M,T,Z,B", [(10_016, 16, 768, 1, 3), (32, 16, 128, 3, 16),
                                       (0, 2, 64, 1, 1)])
def test_batched_scratch_layout(E, M, T, Z, B, cl):
    """B rows, each the scan's shared rows, its cl CTAs' own rows (k_t,
    fit_t, k_cap [T]; scat_z, scat_take [M]), take_e [E], take_c [M] and
    the removed mask [E]: no two pieces overlap, the take rows start at
    batch_take_offset, and a row ends at batch_scratch_words."""
    shared = tffd.scan_scratch_words(E, M, T, Z)
    cta = 3 * T + 2 * M
    take = tffd.batch_take_offset(E, M, T, Z, cl)
    stride = tffd.batch_scratch_words(E, M, T, Z, cl)
    assert take == shared + cl * cta
    pieces = []
    for b in range(B):
        base = b * stride
        pieces.append((base, base + shared))
        pieces += [(base + shared + r * cta, base + shared + (r + 1) * cta) for r in range(cl)]
        pieces += [(base + take, base + take + E), (base + take + E, base + take + E + M),
                   (base + take + E + M, base + take + 2 * E + M)]
    for (a0, a1), (b0, b1) in zip(pieces, pieces[1:]):
        assert a0 <= a1 <= b0 <= b1, (E, M, T, Z, B, cl)
    assert pieces[-1][1] == B * stride
    # a narrower team needs no more scratch than a wider one
    assert stride <= tffd.batch_scratch_words(E, M, T, Z, 16)


# ------------------------------------------------------------- the wrapper


class _RecordingLib:
    """Stands in for the batched library: records each launch's pointer
    count and dims, and that no pointer is null."""

    def __init__(self):
        self.calls = []

    def ffd_batched_launch(self, p, n, d, stream):
        self.calls.append((n, list(d), all(p[i] is not None for i in range(n))))
        return 0


def _check_any_device(t, name, dtype, shape=None):
    """The wrappers' argument check (ffd._check) without its device test."""
    assert t.dtype == dtype and t.is_contiguous(), name
    assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)


@pytest.fixture
def recording(monkeypatch):
    """K4's wrapper on CPU tensors: a recording launcher stands in for the
    library, the argument check skips its device test, and the card's teams
    are the H100's."""
    lib = _RecordingLib()
    monkeypatch.setattr(tffd, "_check", _check_any_device)
    monkeypatch.setattr(tbuild, "load", lambda name="ffd_kernels": lib)
    monkeypatch.setattr(tffd, "_stream", lambda: None)
    monkeypatch.setattr(tffd, "LAUNCHES", dict.fromkeys(tffd.LAUNCHES, 0))
    monkeypatch.setattr(tcons, "batched_fits", lambda *a: dict(H100_TEAMS))
    return lib


def _rows(kind: str, seed: int, n_rows: int):
    """(host args, rows, enc, E, T, Z) of a small fleet's universe with
    n_rows random subsets (the bucket pads them to a multiple of 8)."""
    f = fleet(seed, kind)
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    rng = random.Random(seed)
    n = len(f["cand_node"])
    # every candidate first (the row that needs the most claims), then random subsets
    subs = [list(range(n))] + [sorted(rng.sample(range(n), rng.randint(0, n)))
                               for _ in range(n_rows - 1)]
    rows = tcons.subset_rows(args, pod_cand, pod_run, subs, node_idx, v_delta,
                             args[tcons._V_COUNT0])
    E = int(args[tffd.ARG_INDEX["node_free"]].shape[0])
    T = int(args[tffd.ARG_INDEX["group_compat_t"]].shape[1])
    Z = int(args[tffd.ARG_INDEX["zone_col_mask"]].shape[0])
    return args, rows, enc, E, T, Z


@pytest.mark.parametrize("n_rows,team", [(5, None), (60, None), (200, None), (5, 4), (200, 16),
                                         (60, 1)])
@pytest.mark.parametrize("kind", ["fast", "zone"])
def test_batched_wrapper_hands_the_team_scratch(recording, kind, n_rows, team):
    """The wrapper sizes each row's scratch for the team the launch takes
    (the rule's, or the forced one) and hands the launcher its row words,
    the take rows' offset and that team."""
    args, rows, enc, E, T, Z = _rows(kind, 3, n_rows)
    zone = enc.V > 0
    assert zone == (kind == "zone")
    B = int(rows[0].shape[0])
    M = 16
    tcons._batched_ffd_cuda(args_to_torch(args, "cpu"), *tcons.upload_rows(rows, "cpu"), M, zone,
                            team=team)
    (n, dims, all_set), = recording.calls
    cl = tcons.batched_team(B, H100_TEAMS) if team is None else team
    assert n == 58 and all_set
    assert dims[11] == int(zone) and dims[12] == B
    assert dims[14] == tffd.batch_scratch_words(E, M, T, Z, cl)
    assert dims[15] == tffd.batch_take_offset(E, M, T, Z, cl)
    assert dims[16] == cl
    assert tffd.LAUNCHES[f"ffd_batched_{'zoned' if zone else 'fast'}_scan"] == 1


def test_batched_wrapper_refuses_an_unknown_team(recording):
    """The rule's team reaches the launcher (24 rows: clusters of 4 on the
    H100); a team outside 1, 2, 4, 8, 16 raises before any launch."""
    args, rows, enc, E, T, Z = _rows("fast", 4, 20)
    B = int(rows[0].shape[0])
    targs, trows = args_to_torch(args, "cpu"), tcons.upload_rows(rows, "cpu")
    tcons._batched_ffd_cuda(targs, *trows, 16, False)
    (n, dims, _), = recording.calls
    assert dims[16] == tcons.batched_team(B, H100_TEAMS) == 4
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match=f"team {bad}"):
            tcons._batched_ffd_cuda(targs, *trows, 16, False, team=bad)
    assert len(recording.calls) == 1


# --------------------------------------------- the plain version against JAX


@pytest.mark.parametrize("B", [8, 16, 40])
@pytest.mark.parametrize("M", [2, 16])
@pytest.mark.parametrize("kind", ["saturate", "mixed"], ids=["fast", "zoned"])
def test_batched_ffd_plain_matches_jax(kind, M, B):
    """K4's plain version against the JAX _batched_ffd on B rows (B - 3
    subsets, the bucket's padding rows included), every output equal."""
    args, rows, enc, E, T, Z = _rows(kind, 11 + B, B - 3)
    assert int(rows[0].shape[0]) == B
    zone = enc.V > 0
    assert zone == (kind == "mixed")
    j = jcons._batched_ffd(tuple(args), *rows, M, False, zone)
    t = tcons.batched_ffd_plain(args_to_torch(args, "cpu"), *tcons.upload_rows(rows, "cpu"), M,
                                zone)
    assert_outputs_equal(j, t)
    used = np.asarray(j.state.used)
    if kind == "saturate" and M == 2:
        assert (used == M).any(), "no row saturated the claim slots"
