"""The lanes scans as one thread-block cluster a lane, on the CPU.

K15 (ffd_lanes_kernel), K17 (the same kernel over a solve's run blocks)
and K17s (ffd_lanes_sparse_kernel) run one cluster of CL CTAs a lane, CL
chosen at launch from the lanes B and the clusters of 16, 8, 4 and 2 CTAs
the card holds at once (csrc/ffd_kernels.cu lanes_cl). The kernels run
only on the card (chip_smoke.py phases 9-11 and 15 hold them against their
plain versions there); here:

- solver/cuda/ffd.py lanes_cluster, the launcher's rule mirrored: on the
  H100's fit table (16 -> 7, 8 -> 15, 4 -> 30, 2 -> 66 clusters at once,
  measured on an NVIDIA H100 80GB HBM3 at 700.00 W: PERF.md §6), on a
  card that refuses the non-portable 16, and past every fit (the smallest
  size the card holds, the lanes in waves); B < 1 and a card that holds
  no size raise.
- the lanes' scratch: B lanes of a cluster scan's scratch (the shared rows,
  then MAX_CL CTAs' own rows), no two pieces overlapping; the K15, K17 and
  K17s wrappers hand the launcher a [B, cluster_scratch_words] scratch and
  that per-lane count (_lane_counts), and step the shared tables by 0
  (on CPU tensors: a recording launcher stands in for the library, and
  the argument check skips its device test).
- the plain lanes (K15's plain version) against the JAX batched_solve at
  B = 16 lanes, fast and zoned, on small fleets: past one wave of 8-CTA
  clusters, as phase 15 launches them.
- the plain sharded scan (K17's / K17s's plain version) against the JAX
  ffd_solve_sharded / ffd_solve_sharded_sparse at Nd 8, fast and zoned.

Every output is an integer: the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import jax
from karpenter_tpu.parallel import sharded as jsharded
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.parallel import sharded as tsharded
from karpenter_tpu_torch.solver.convert import args_to_torch, output_to_numpy
from karpenter_tpu_torch.solver.cuda import build as tbuild
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_cohort import _member_spec
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_solver import build

torch.set_num_threads(1)

# clusters of each size an NVIDIA H100 80GB HBM3 (700.00 W) holds at once at
# the lanes instances' widest launch (PERF.md §6, Step 0 of the lanes section)
H100_FITS = {16: 7, 8: 15, 4: 30, 2: 66}


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("B,cl", [(1, 16), (2, 16), (7, 16), (8, 8), (15, 8), (16, 4), (30, 4),
                                  (31, 2), (32, 2), (66, 2), (67, 2), (1_000, 2)])
def test_lanes_cluster_on_the_h100(B, cl):
    """The largest size that holds all B lanes at once; past fit(2), CL 2
    and the lanes run in waves."""
    assert tffd.lanes_cluster(B, H100_FITS) == cl


@pytest.mark.parametrize("B,cl", [(1, 8), (15, 8), (16, 4), (40, 2), (500, 2)])
def test_lanes_cluster_without_the_non_portable_size(B, cl):
    """A card that refuses 16 CTAs a cluster (fit 0, or no entry) starts at 8."""
    refused = {**H100_FITS, 16: 0}
    assert tffd.lanes_cluster(B, refused) == cl
    assert tffd.lanes_cluster(B, {k: v for k, v in H100_FITS.items() if k != 16}) == cl


def test_lanes_cluster_past_every_fit():
    """Past every size the launch takes the smallest size the card holds at
    all, whichever that is; a card that holds no size, or B < 1, raises."""
    assert tffd.lanes_cluster(100, {16: 1, 8: 2, 4: 4, 2: 0}) == 4
    assert tffd.lanes_cluster(3, {16: 2, 8: 0, 4: 0, 2: 0}) == 16
    assert tffd.lanes_cluster(2, {16: 2, 8: 0, 4: 0, 2: 0}) == 16
    with pytest.raises(ValueError, match="no cluster"):
        tffd.lanes_cluster(1, {16: 0, 8: 0, 4: 0, 2: 0})
    with pytest.raises(ValueError, match="B=0"):
        tffd.lanes_cluster(0, H100_FITS)
    assert tffd.LANE_CLUSTERS == (16, 8, 4, 2) and tffd.cluster_info("cpu") is None
    assert tffd.lanes_cluster_info("cpu", 8) is None


# ------------------------------------------------------------- the scratch


@pytest.mark.parametrize("E,M,T,Z,B", [(8, 512, 768, 3, 8), (0, 64, 128, 1, 1),
                                       (2_016, 1_024, 732, 32, 16)])
def test_lanes_scratch_layout(E, M, T, Z, B):
    """B lanes, each the shared rows then MAX_CL CTAs' own rows (k_t, fit_t,
    k_cap [T]; scat_z, scat_take [M]): no two pieces overlap, and the lane
    stride _lane_counts gives a [B, cluster_scratch_words] scratch is a
    lane's cluster scratch."""
    shared = tffd.scan_scratch_words(E, M, T, Z)
    cta = 3 * T + 2 * M
    stride = tffd.cluster_scratch_words(E, M, T, Z)
    pieces = []
    for b in range(B):
        base = b * stride
        pieces.append((base, base + shared))
        pieces += [(base + shared + r * cta, base + shared + (r + 1) * cta)
                   for r in range(tffd.MAX_CL)]
    for (a0, a1), (b0, b1) in zip(pieces, pieces[1:]):
        assert a0 <= a1 <= b0 <= b1, (E, M, T, Z, B)
    assert pieces[-1][1] == B * stride
    scratch = torch.empty((B, stride), dtype=torch.int32)
    lo, hi = tffd._lane_counts([scratch], B, ())
    assert lo + (hi << 32) == stride


class _RecordingLib:
    """Stands in for a lanes library: records each launch's dims."""

    def __init__(self):
        self.calls = []

    def _launch(self, p, n, d, stream):
        self.calls.append((n, list(d)))
        return 0

    ffd_lanes_launch = _launch
    ffd_lanes_sparse_launch = _launch


def _small_fleets(zone: bool, B: int, seed: int):
    """B small fleets of one shape bucket: (encoded input, host_kernel_args)."""
    rng = random.Random(seed)
    out = []
    for i in range(B):
        enc = jencode.encode(jencode.quantize_input(build(_member_spec(rng, f"m{i}", zone),
                                                          "karpenter_tpu")))
        assert (enc.V > 0) == zone
        out.append((enc, jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)))
    return out


def _check_any_device(t, name, dtype, shape=None):
    """The wrappers' argument check (ffd._check) without its device test."""
    assert t.dtype == dtype and t.is_contiguous(), name
    assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)


@pytest.fixture
def recording(monkeypatch):
    """The CUDA wrappers on CPU tensors: a recording launcher stands in for
    the library, and the argument check skips its device test."""
    lib = _RecordingLib()
    monkeypatch.setattr(tffd, "_check", _check_any_device)
    monkeypatch.setattr(tbuild, "load", lambda name="ffd_kernels": lib)
    monkeypatch.setattr(tffd, "_stream", lambda: None)
    monkeypatch.setattr(tffd, "LAUNCHES", dict.fromkeys(tffd.LAUNCHES, 0))
    return lib


def _scratch_counts(dims, n_ptrs):
    """(per-lane counts of every pointer) from a lanes launch's dims."""
    d = dims[13:13 + 2 * n_ptrs]
    return [d[2 * i] + (d[2 * i + 1] << 32) for i in range(n_ptrs)]


@pytest.mark.parametrize("zone", [False, True])
def test_lanes_wrapper_hands_the_cluster_scratch(recording, zone):
    """K15's wrapper: B, then every array's per-lane count, the scratch's a
    lane's cluster scratch (the wrapper allocates [B, cluster_scratch_words])."""
    B = 3
    hosts = [h[0] for _, h in _small_fleets(zone, B, 7)]
    stacked = tuple(np.stack([h[j] for h in hosts]) for j in range(len(hosts[0])))
    args = args_to_torch(stacked, "cpu")
    out = tffd._ffd_solve_lanes_cuda(*args, max_claims=64, zone_engine=zone)
    (n, dims), = recording.calls
    E, T, Z = (int(args[tffd.ARG_INDEX[k]].shape[1])
               for k in ("node_free", "type_alloc", "zone_col_mask"))
    cnt = _scratch_counts(dims, n)
    assert n == 53 and dims[11] == int(zone) and dims[12] == B
    assert cnt[52] == tffd.cluster_scratch_words(E, 64, T, Z)
    assert all(c > 0 for c in cnt[:32]), "every lanes input steps per lane"
    assert out.take_e.shape[0] == B
    assert tffd.LAUNCHES[f"ffd_lanes_{'zoned' if zone else 'fast'}_scan"] == 1


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_sharded_wrapper_hands_the_cluster_scratch(recording, sparse):
    """K17's / K17s's wrapper: the run blocks, the index tables, the carry,
    the outputs and the scratch step per lane (the scratch by a lane's
    cluster scratch); the 34 shared tables by 0."""
    Nd = 4
    (enc, (host, dims0, _)), = _small_fleets(True, 1, 8)
    rgb, rcb = jencode.mesh_run_blocks(host[0], host[1], Nd)
    sh = args_to_torch((rgb, rcb) + tuple(host[2:]), "cpu")
    if sparse:
        rqi, rvi = jencode.sparse_run_tables(enc, dims0["Sp"])
        Sblk = dims0["Sp"] // Nd
        sq, sv = args_to_torch((rqi.reshape(Nd, Sblk, -1), rvi.reshape(Nd, Sblk, -1)), "cpu")
        tffd._ffd_solve_sharded_cuda(*sh, max_claims=64, zone_engine=True, sparse=(sq, sv))
    else:
        tffd._ffd_solve_sharded_cuda(*sh, max_claims=64, zone_engine=True)
    (n, dims), = recording.calls
    cnt = _scratch_counts(dims, n)
    E, T, Z = (int(sh[tffd.ARG_INDEX[k]].shape[0])
               for k in ("node_free", "type_alloc", "zone_col_mask"))
    assert n == 53 + 2 * sparse and dims[12] == Nd
    assert cnt[52] == tffd.cluster_scratch_words(E, 64, T, Z)
    assert cnt[0] > 0 and cnt[1] > 0 and not any(cnt[2:32]), "only the run blocks step"
    assert all(c > 0 for c in cnt[32:])


# --------------------------------------------------- the plain lanes vs JAX


@pytest.mark.parametrize("zone", [False, True])
def test_plain_lanes_match_jax_past_a_wave(zone):
    """16 lanes (more than the 15 clusters of 8 CTAs an H100 holds at once):
    the plain lanes equal the JAX batched_solve, every FFDOutput field."""
    B, M = 16, 64
    hosts = [h[0] for _, h in _small_fleets(zone, B, 101 + zone)]
    stacked = tuple(np.stack([h[j] for h in hosts]) for j in range(len(hosts[0])))
    jo = jsharded.batched_solve(jsharded.make_mesh(1), stacked, max_claims=M, zone_engine=zone)
    to = output_to_numpy(tsharded.batched_solve(args_to_torch(stacked, "cpu"), max_claims=M,
                                                zone_engine=zone))
    for k in ("take_e", "take_c", "leftover"):
        np.testing.assert_array_equal(to[k], np.asarray(getattr(jo, k)), err_msg=k)
    for f, t in to["state"].items():
        np.testing.assert_array_equal(t, np.asarray(getattr(jo.state, f)), err_msg=f)
    assert to["take_e"].shape[0] == B and int(to["take_c"].sum() + to["take_e"].sum()) > 0


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("zone", [False, True])
def test_plain_sharded_matches_jax_at_nd8(zone, sparse):
    """Eight run blocks of a small fleet (two runs a block): the plain
    sharded scan equals the JAX ffd_solve_sharded (its sparse twin with the
    index tables), every lane and leaf."""
    Nd, M = 8, 64
    spec = _member_spec(random.Random(55 + zone), "s", zone)
    enc = jencode.encode(jencode.quantize_input(build(spec, "karpenter_tpu")))
    assert (enc.V > 0) == zone
    host, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    rgb, rcb = jencode.mesh_run_blocks(host[0], host[1], Nd)
    sh = (rgb, rcb) + tuple(host[2:])
    if sparse:
        Sblk = dims["Sp"] // Nd
        rqi, rvi = jencode.sparse_run_tables(enc, dims["Sp"])
        sq, sv = rqi.reshape(Nd, Sblk, -1), rvi.reshape(Nd, Sblk, -1)
        j = jffd.ffd_solve_sharded_sparse(sq, sv, *sh, max_claims=M, zone_engine=zone)
        t = tffd.ffd_solve_sharded_sparse(*args_to_torch((sq, sv) + sh, "cpu"), max_claims=M,
                                          zone_engine=zone)
    else:
        j = jffd.ffd_solve_sharded(*sh, max_claims=M, zone_engine=zone)
        t = tffd.ffd_solve_sharded(*args_to_torch(sh, "cpu"), max_claims=M, zone_engine=zone)
    j = jax.tree_util.tree_map(np.asarray, j)
    t = output_to_numpy(t)
    assert t["take_e"].shape[0] == Nd
    for k in ("take_e", "take_c", "leftover"):
        np.testing.assert_array_equal(t[k], getattr(j, k), err_msg=k)
    for f, v in t["state"].items():
        np.testing.assert_array_equal(v, getattr(j.state, f), err_msg=f)
    assert int(t["take_c"].sum() + t["take_e"].sum()) > 0
