"""The delta pack (K2 + K3 in one launch: cuda/ffd.py pack_delta) against the
JAX package, on the CPU.

- pack_delta_plain, and pack_delta on CPU tensors, equal the JAX
  `_pack_outputs_delta` (backend.py:635) word for word: at the scan cases'
  outputs, on seeded take grids (all zeros, every cell nonzero, more
  entries than the capacity, a take past 65535) and on seeded claim tables
  (more distinct rows than cap_u, rows equal in every word but the last,
  duplicates far apart, every row equal);
- the buffer round-trips through TorchSolver._pack_dispatch's unpack to the
  fields the JAX unpack decodes, and its entries are the take grids' nonzero
  cells in run-major order;
- TorchSolver(device="cpu") decides a surge-shaped fleet as TPUSolver()
  does, with the same fetch bytes, and as its dense output pack does;
- the CUDA wrappers' hand-off, with a recording launcher in place of the
  library: the launch's dims, the one allocation (the buffer, then the
  kernel's scratch), the returned view, the cluster rule and the count.

Every value is an integer or a bit pattern: the tolerance is exact.
"""

import types

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.cuda import build as tbuild
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_ffd import M, SCAN_CASES, _solve_both
from tests.test_torch_jax_release import release_if_crowded
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_pack import _outputs
from tests.test_torch_solver import as_data, build, pod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drop_jax_programs():
    """Each (cap, cap_u) of the JAX pack compiles a program of its own:
    after each test, drop the JAX programs if the process maps past the
    budget."""
    yield
    release_if_crowded()


def _both(jout, tout, cap: int, cap_u: int) -> np.ndarray:
    """The JAX buffer, held against the plain version and the CPU entry point."""
    want = np.asarray(jbackend._pack_outputs_delta(jout, cap, cap_u))
    st = tout.state
    for got in (tffd.pack_delta_plain(tout.take_e, tout.take_c, tout.leftover, st, cap, cap_u),
                tffd.pack_delta(tout.take_e, tout.take_c, tout.leftover, st, cap, cap_u),
                tbackend._pack_outputs_delta(tout, cap, cap_u)):
        assert got.dtype == torch.int32 and got.dim() == 1
        assert np.array_equal(got.numpy(), want)
    Sp, M_ = tout.take_c.shape
    Wt = (st.c_mask.shape[1] + 31) // 32 + 1 + st.c_gbits.shape[1] + 1
    assert want.size == tffd.pack_delta_words(Sp, M_, cap, cap_u, Wt)
    return want


@pytest.mark.parametrize("name", ["existing_nodes", "hostname_q_kinds", "fleet_1"])
def test_pack_delta_matches_jax_at_scan_outputs(name):
    enc, _, j, t = _solve_both(SCAN_CASES[name])
    total = int(sum(len(p) for p in enc.group_pods))
    Sp, Ep = t.take_e.shape
    flat = _both(j, t, tbackend.delta_capacity(total, Sp, Ep, M),
                 tbackend.delta_uniq_capacity(Sp, M))
    assert flat[0] == 0 and flat[1] > 0 and flat[2] > 0


def _set_takes(jout, tout, take_e, take_c):
    """jout / tout with these take grids."""
    jout = jout._replace(take_e=take_e, take_c=take_c)
    tout = tout._replace(take_e=torch.from_numpy(take_e.copy()),
                         take_c=torch.from_numpy(take_c.copy()))
    return jout, tout


TAKES = ["zeros", "dense", "n_over_cap", "take_over_u16"]


@pytest.mark.parametrize("case", TAKES)
def test_pack_delta_matches_jax_on_take_grids(case):
    Sp, Ep, Mc, T = 16, 8, 64, 100
    jout, tout = _outputs(31 + TAKES.index(case), Sp, Ep, Mc, T, False)
    rng = np.random.default_rng(7)
    te = np.where(rng.random((Sp, Ep)) < 0.2, rng.integers(1, 90, (Sp, Ep)), 0).astype(np.int32)
    tc = np.where(rng.random((Sp, Mc)) < 0.1, rng.integers(1, 90, (Sp, Mc)), 0).astype(np.int32)
    cap = 256
    if case == "zeros":
        te[:], tc[:] = 0, 0
    elif case == "dense":
        te, tc = rng.integers(1, 65536, (Sp, Ep)).astype(np.int32), rng.integers(
            1, 65536, (Sp, Mc)).astype(np.int32)
        cap = Sp * (Ep + Mc)
    elif case == "n_over_cap":
        cap = int((te > 0).sum() + (tc > 0).sum()) - 3
    else:
        tc[Sp // 2, 5] = 70_000
    flat = _both(*_set_takes(jout, tout, te, tc), cap, 64)
    n = int((te > 0).sum() + (tc > 0).sum())
    assert flat[1] == n
    assert flat[0] == int(case in ("n_over_cap", "take_over_u16"))


def _claim_table(case: str, Mc: int, T: int, W: int, seed: int):
    """(c_mask, c_zc_bits, c_gbits, c_pool) of a seeded claim table."""
    rng = np.random.default_rng(seed)
    B = 40 if case == "n_u_over_cap_u" else 5
    masks = rng.random((B, T)) < 0.4
    zc = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    gb = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, B, Mc)
    pool = (pick % 3).astype(np.int32)
    if case == "last_word":  # pairs of rows equal in every word but the pool
        pool = np.where(rng.random(Mc) < 0.5, pool, -1).astype(np.int32)
    if case == "far_duplicates":  # every row distinct but the last, a copy of the first
        masks = rng.random((Mc, T)) < 0.4
        zc = rng.integers(0, 2**32, Mc, dtype=np.uint64).astype(np.uint32)
        gb = rng.integers(0, 2**32, (Mc, W), dtype=np.uint64).astype(np.uint32)
        pool = np.arange(Mc, dtype=np.int32)
        masks[-1], zc[-1], gb[-1], pool[-1] = masks[0], zc[0], gb[0], pool[0]
        pick = np.arange(Mc)
    if case == "all_equal":
        pick[:] = 0
        pool[:] = 0
    return masks[pick], zc[pick], gb[pick], pool


CLAIMS = ["fits", "n_u_over_cap_u", "last_word", "far_duplicates", "all_equal"]


@pytest.mark.parametrize("case", CLAIMS)
def test_pack_delta_matches_jax_on_claim_tables(case):
    Sp, Ep, Mc, T, W = 16, 8, 64, 100, 2
    jout, tout = _outputs(53 + CLAIMS.index(case), Sp, Ep, Mc, T, False)
    c_mask, zc, gb, pool = _claim_table(case, Mc, T, W, 3 + CLAIMS.index(case))
    jst = jout.state._replace(c_mask=c_mask, c_zc_bits=zc, c_gbits=gb, c_pool=pool)
    tst = tout.state._replace(c_mask=torch.from_numpy(c_mask.copy()),
                              c_zc_bits=torch.from_numpy(zc.view(np.int32).copy()),
                              c_gbits=torch.from_numpy(gb.view(np.int32).copy()),
                              c_pool=torch.from_numpy(pool.copy()))
    cap_u = 16
    flat = _both(jout._replace(state=jst), tout._replace(state=tst), Sp * (Ep + Mc), cap_u)
    n_u = len({(c_mask[m].tobytes(), int(zc[m]), gb[m].tobytes(), int(pool[m]))
               for m in range(Mc)})
    assert flat[2] == n_u and flat[0] == int(n_u > cap_u)
    if case == "far_duplicates":
        mid = flat[-1 - Mc // 2:-1].view(np.uint16)
        assert mid[Mc - 1] == mid[0] == 0 and n_u == Mc - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_round_trips_through_the_unpack(seed):
    """_pack_dispatch's unpack decodes the port's buffer to the JAX unpack's
    fields, and the entries are the take grids' nonzero cells, run-major."""
    Sp, Ep, Mc, T = 16, 8, 64, 100
    jout, tout = _outputs(71 + seed, Sp, Ep, Mc, T, False)
    rng = np.random.default_rng(seed)
    te = np.where(rng.random((Sp, Ep)) < 0.2, rng.integers(1, 300, (Sp, Ep)), 0).astype(np.int32)
    tc = np.where(rng.random((Sp, Mc)) < 0.1, rng.integers(1, 300, (Sp, Mc)), 0).astype(np.int32)
    jout, tout = _set_takes(jout, tout, te, tc)
    total = int(te.sum() + tc.sum())
    port = TorchSolver(device="cpu")
    flat_dev, unpack = port._pack_dispatch(tout, total_pods=total)
    got = unpack(port._fetch(flat_dev))
    tpu = TPUSolver()
    jflat, junpack = tpu._pack_dispatch(jout, total_pods=total)
    want = junpack(np.asarray(jflat))
    assert "entries" in got and set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    grid = np.concatenate([te, tc], axis=1)
    s, c = np.nonzero(grid)
    assert np.array_equal(got["entries"], np.stack([s, c, grid[s, c]], axis=1))
    assert port.ledger.total["d2h_bytes"] == np.asarray(jflat).nbytes


def _surge_spec(pods_per: int = 30) -> dict:
    """A surge-shaped fleet: eight deployments of identical pods over two
    pools (each deployment a run)."""
    sizes = [("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi"), ("250m", "512Mi"),
             ("4", "8Gi"), ("1500m", "3Gi"), ("750m", "1536Mi"), ("3", "6Gi")]
    pods = [pod(f"d{d}-{i}", cpu=c, mem=m) for d, (c, m) in enumerate(sizes)
            for i in range(pods_per)]
    return dict(pods=pods, pools=[dict(name="general", weight=10), dict(name="spot", weight=1)],
                nodes=[])


def test_surge_fleet_decides_as_tpu_solver():
    spec = _surge_spec()
    port = TorchSolver(device="cpu")
    got = as_data(port.solve(build(spec, "karpenter_tpu_torch")))
    tpu = TPUSolver()
    assert got == as_data(tpu.solve(build(spec, "karpenter_tpu")))
    assert port.stats["device_solves"] == 1 and port.stats["wide_refetches"] == 0
    assert port.ledger.solve["d2h_bytes"] == tpu.ledger.solve["d2h_bytes"]
    dense = TorchSolver(device="cpu", device_decode=False)
    assert as_data(dense.solve(build(spec, "karpenter_tpu_torch"))) == got


# ---- the CUDA wrappers' hand-off (no card: a recording launcher) -------------


class _RecordingLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(ptrs, n, dims, stream):
            self.calls.append((name, n, [dims[i] for i in range(10 if name == "pack_delta_launch"
                                                                   else 2)]))
            return 0

        return launch


def _check_any_device(t, name, dtype, shape=None):
    """The wrappers' argument check (ffd._check) without its device test."""
    assert t.dtype == dtype and t.is_contiguous(), name
    assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)


@pytest.fixture
def recording(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(tffd, "_check", _check_any_device)
    monkeypatch.setattr(tbuild, "load", lambda name="ffd_kernels": lib)
    monkeypatch.setattr(tffd, "_stream", lambda: None)
    monkeypatch.setattr(tffd, "LAUNCHES", dict.fromkeys(tffd.LAUNCHES, 0))
    return lib


@pytest.mark.parametrize("hash_bits,cl", [(64, None), (2, None), (64, 1), (64, 16)])
def test_pack_delta_wrapper_hands_one_buffer(recording, hash_bits, cl):
    Sp, Ep, Mc, T = 16, 8, 64, 100
    _, tout = _outputs(5, Sp, Ep, Mc, T, False)
    cap, cap_u = 256, 32
    flat = tffd._pack_delta_cuda(tout.take_e, tout.take_c, tout.leftover, tout.state, cap,
                                 cap_u, hash_bits=hash_bits, cl=cl)
    (name, n, dims), = recording.calls
    Wt = (T + 31) // 32 + 1 + 2 + 1
    words = tffd.pack_delta_words(Sp, Mc, cap, cap_u, Wt)
    want_cl = tffd.pack_delta_cluster(Sp, Ep, Mc, T) if cl is None else cl
    assert name == "pack_delta_launch" and n == 9
    assert dims[:9] == [Sp, Ep, Mc, T, 2, cap, cap_u, want_cl, hash_bits]
    assert dims[9] == tffd.pack_delta_scratch(words, Mc, Wt)
    assert flat.numel() == words and flat.untyped_storage().nbytes() == 4 * dims[9]
    assert tffd.LAUNCHES["pack_delta"] == 1


def test_mask_words_wrapper(recording):
    c_mask = torch.zeros((64, 100), dtype=torch.bool)
    words = tffd._mask_words_cuda(c_mask)
    assert recording.calls == [("mask_words_launch", 2, [64, 100])]
    assert tuple(words.shape) == (64, 4) and tffd.LAUNCHES["mask_words"] == 1


def test_pack_delta_cluster_rule():
    """CTAs a launch: the smallest power of two with ~64 KiB of take grid
    and type mask each, at most 16."""
    assert tffd.pack_delta_cluster(16, 8, 64, 100) == 1
    assert tffd.pack_delta_cluster(32, 8, 512, 768) == 8  # the surge
    assert tffd.pack_delta_cluster(1008, 2016, 1024, 768) == 16  # class_contended
    assert tffd.pack_delta_cluster(256, 64, 8192, 730) == 16


def test_parts_refuse_the_card():
    """On the card K2's and K3's parts run only inside pack_delta."""
    fake = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError):
        tffd.compact_takes(fake, fake, 256)
    with pytest.raises(ValueError):
        tffd.compact_claim_meta(fake, fake, fake, fake, 16)


def test_wide_pack_words_match_jax():
    """The wide re-fetch's buffer (its type-mask words from pack_mask_words)
    equals the JAX `_pack_outputs_wide` word for word."""
    jout, tout = _outputs(91, 16, 8, 64, 100, False)
    want = np.asarray(jbackend._pack_outputs_wide(jout))
    assert np.array_equal(tbackend._pack_outputs_wide(tout).numpy(), want)
    st = jout.state
    assert np.array_equal(tffd.pack_mask_words(tout.state.c_mask).numpy(),
                          jbackend.pack_words(np.asarray(st.c_mask), 100).view(np.int32))

