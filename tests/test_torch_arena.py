"""The port's argument arena against the JAX package.

- `unpack_plain` (the plain version of the K8 unpack kernel) equals the
  JAX `_unpack_fn(specs, None)` on seeded segment lists packed as the arena
  packs them: every ARG_SPEC dtype (int32, uint32, bool) and the convex
  problem's float32, odd-sized bool
  tables in front of int32/uint32 entries (unaligned offsets), and bool
  bytes 2..255 read as True.
- The transfer ledger equals the JAX ledger: a sequence of solves (cold,
  exact repeat, pod mutation, bucket change, return) through
  TorchSolver(device="cpu") and TPUSolver() uploads the same stale entries
  with the same bytes, arrays and messages on every solve, and fetches the
  same bytes; tests/test_transfer_arena.py's cases (exact hit uploads 0
  bytes, a delta solve is one packed message, a return to a bucket is an
  exact hit, arena=False uploads per array, invalidate is safe at any
  time) hold for the port; the relax ladder's rung table and the
  consolidation universe are resident.
Tolerance: exact equality (bytes and integer decisions).
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.arena import _unpack_fn
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.tpu.ffd import ARG_SPEC
from karpenter_tpu_torch.solver import arena as tarena
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.convert import args_to_torch
from karpenter_tpu_torch.solver.cuda import arena as tunpack
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_relax import to_port
from tests.test_torch_solver import as_data

torch.set_num_threads(1)


# -- unpack: plain version against the JAX unpack ------------------------------


def _pack(arrays):
    """The arena's packing (arena.py:697-712): entries back to back."""
    specs, parts, off = [], [], 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        specs.append((off, a.shape, a.dtype.str))
        parts.append(a.reshape(-1).view(np.uint8))
        off += a.nbytes
    return np.concatenate(parts), tuple(specs)


def _segment_list(seed: int):
    """Seeded arrays of every ARG_SPEC dtype, odd-sized bools in front of
    int32 and uint32 entries, scalars-as-[1] and multi-axis shapes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(6, 14))):
        kind = int(rng.integers(0, 3))
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(x) for x in rng.integers(1, 7, size=ndim))
        if kind == 0:
            out.append(rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32))
        elif kind == 1:
            out.append(rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32))
        else:
            out.append(rng.random(shape) < 0.5)
        if kind == 2 or rng.random() < 0.3:
            # an odd-sized bool table right after: the next entry lands at
            # an offset that is not a multiple of 4
            out.append(rng.random((int(rng.integers(1, 4)) * 2 + 1,)) < 0.5)
            out.append(rng.integers(-9, 9, size=(3,)).astype(np.int32 if seed % 2 else np.uint32))
    return out


def _check_unpack(buf: np.ndarray, specs, jax_bits=None):
    want = _unpack_fn(specs, None)(buf if jax_bits is None else jax_bits)
    got = tunpack.unpack_plain(torch.from_numpy(buf.copy()), specs)
    assert len(got) == len(want) == len(specs)
    for (off, shape, dstr), w, g in zip(specs, want, got):
        w = np.asarray(w)
        g = g.numpy()
        if dstr == "<u4":
            g = g.view(np.uint32)
        assert w.dtype == g.dtype and w.shape == g.shape == tuple(shape), (dstr, w.dtype, g.dtype)
        assert np.array_equal(w, g), (off, shape, dstr)


@pytest.mark.parametrize("seed", range(6))
def test_unpack_plain_matches_jax(seed):
    arrays = _segment_list(seed)
    buf, specs = _pack(arrays)
    assert any(off % 4 for off, _, d in specs if d != "|b1"), "no unaligned int entry"
    assert {d for _, _, d in specs} == {"<i4", "<u4", "|b1"}
    _check_unpack(buf, specs)
    # the port's packing is this packing
    parts, nbytes, tspecs = tunpack.pack(arrays)
    assert tspecs == specs and nbytes == buf.nbytes
    assert np.array_equal(np.concatenate(parts), buf)
    # the packed bytes round-trip to the arrays themselves
    for a, g in zip(arrays, tunpack.unpack_plain(torch.from_numpy(buf), specs)):
        g = g.numpy()
        assert np.array_equal(g.view(a.dtype) if a.dtype == np.uint32 else g, a)


@pytest.mark.parametrize("seed", range(3))
def test_unpack_bool_bytes_2_to_255(seed):
    """Bool segments read every nonzero byte as True, as the JAX unpack
    does (`seg != 0`)."""
    arrays = _segment_list(10 + seed)
    buf, specs = _pack(arrays)
    rng = np.random.default_rng(seed)
    raw = buf.copy()
    for off, shape, dstr in specs:
        if dstr == "|b1":
            n = int(np.prod(shape))
            raw[off : off + n] = rng.integers(0, 256, size=n, dtype=np.uint8)
    assert any(raw[off] >= 2 for off, _, d in specs if d == "|b1")
    _check_unpack(raw, specs)


def test_unpack_rejects_other_dtypes():
    # float32 is an arena dtype since the convex problem adopts into it
    # (test_unpack_float32_matches_jax); wider types are not
    for dt in (np.float64, np.int64):
        buf, specs = _pack([np.zeros(3, dt)])
        with pytest.raises(ValueError):
            tunpack.unpack_plain(torch.from_numpy(buf), specs)


@pytest.mark.parametrize("seed", range(3))
def test_unpack_float32_matches_jax(seed):
    """The convex problem's segments (solver/convex.py pad_problem: float32
    and int32 rows, a bool mask) unpack bit for bit as the JAX unpack reads
    them, behind odd-sized bools too (unaligned float32 entries); infinities,
    NaN and negative zero keep their bits."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((5, 3)).astype(np.float32)
    f[0, :3] = [np.inf, -0.0, np.nan]
    arrays = [f, rng.integers(0, 9, 5).astype(np.int32), rng.random((3,)) < 0.5,
              rng.random(7).astype(np.float32), rng.random((5, 9)) < 0.5]
    buf, specs = _pack(arrays)
    assert any(off % 4 for off, _, d in specs if d == "<f4"), "no unaligned float32 entry"
    want = _unpack_fn(specs, None)(buf)
    got = tunpack.unpack_plain(torch.from_numpy(buf.copy()), specs)
    for a, w, g in zip(arrays, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype == a.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes() == a.tobytes()


def test_adopt_tensors_equal_the_kernel_args():
    """A cold adopt through the plain unpack gives the tensors
    args_to_torch gives (uint32 as int32 bits, bools as bool)."""
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    enc = encode(quantize_input(to_port(_inp(40, specs=3))))
    host_args, _, prov = tb.host_kernel_args(enc, TorchSolver._bucket)
    ar = tarena.ArgumentArena(device="cpu")
    got = ar.adopt(host_args, prov)
    for g, w in zip(got, args_to_torch(host_args, "cpu")):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ar.last_stale == tuple(range(len(ARG_SPEC)))
    assert ar.ledger.total["h2d_bytes"] == sum(a.nbytes for a in host_args)


def test_digest_pinned():
    from karpenter_tpu.solver import arena as jarena

    for a in (np.arange(12, dtype=np.int32).reshape(3, 4), np.ones(5, bool),
              np.arange(7, dtype=np.uint32)[::2]):
        assert tarena._digest(a) == jarena._digest(a)


# -- the ledger against the JAX ledger -----------------------------------------

_CPUS = [
    "150m", "250m", "300m", "500m", "700m", "900m", "1", "1100m", "1300m",
    "1500m", "1700m", "1900m", "2", "2100m", "2300m", "2500m", "2700m",
    "2900m", "3", "3100m",
]
_LEDGER = ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs")


def _inp(n=40, specs=1, prefix="p"):
    """`specs` distinct pod sizes: specs=20 pushes the run/group axes past
    the first bucket edge (Sp/Gp: 16), a different arena bucket."""
    pods = [mkpod(f"{prefix}{i}", cpu=_CPUS[i % specs]) for i in range(n)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def _lifecycle():
    a = _inp(40, specs=3)
    return [
        ("cold", a),
        ("exact-hit", a),
        ("mutate", dataclasses.replace(a, pods=a.pods[:-3])),
        ("bucket-change", _inp(60, specs=20, prefix="q")),
        ("back-to-first-bucket", a),
    ]


def test_ledger_matches_jax_across_lifecycle():
    port, tpu, off = TorchSolver(device="cpu"), TPUSolver(), TorchSolver(device="cpu", arena=False)
    for tag, inp in _lifecycle():
        tinp = to_port(inp)
        got = as_data(port.solve(tinp))
        assert got == as_data(tpu.solve(inp)), tag
        assert got == as_data(off.solve(tinp)), tag
        assert port.arena.last_stale == tpu.arena.last_stale, tag
        for k in _LEDGER:
            assert port.ledger.solve[k] == tpu.ledger.solve[k], (tag, k, port.ledger.solve,
                                                                 tpu.ledger.solve)
    assert port.ledger.outcomes == tpu.ledger.outcomes
    assert port.ledger.total == {k: tpu.ledger.total[k] for k in port.ledger.total}
    assert port.ledger.arena_hit_rate == tpu.ledger.arena_hit_rate
    assert port.ledger.upload_bytes_per_solve == tpu.ledger.upload_bytes_per_solve
    st = port.arena.stats
    assert st["full_uploads"] >= 2 and st["delta_uploads"] >= 1 and st["exact_hits"] >= 1, st
    assert len(port.arena._buckets) == 2


def test_arena_off_ledger_matches_jax():
    """arena=False ships one message per array, as TPUSolver(arena=False)."""
    jencode._CORE_CACHE.clear()
    jbackend._DEV_CACHE.clear()
    port, tpu = TorchSolver(device="cpu", arena=False), TPUSolver(arena=False)
    for tag, inp in _lifecycle():
        port.solve(to_port(inp))
        tpu.solve(inp)
        for k in _LEDGER:
            assert port.ledger.solve[k] == tpu.ledger.solve[k], (tag, k, port.ledger.solve,
                                                                 tpu.ledger.solve)
    assert port.arena is None and port.ledger.outcomes == {
        "exact_hit": 0, "delta_upload": 0, "full_upload": 0}


def test_exact_hit_uploads_zero_bytes():
    s = TorchSolver(device="cpu")
    inp = to_port(_inp(40))
    s.solve(inp)
    assert s.ledger.outcomes["full_upload"] == 1
    full_bytes = s.ledger.solve["h2d_bytes"]
    assert full_bytes > 0 and s.ledger.solve["h2d_msgs"] == 1
    s.solve(inp)
    assert s.ledger.solve["h2d_bytes"] == 0
    assert s.ledger.solve["h2d_arrays"] == 0
    assert s.ledger.solve["h2d_msgs"] == 0
    assert s.ledger.outcomes["exact_hit"] == 1
    assert s.ledger.solve["d2h_bytes"] > 0
    assert s.ledger.arena_hit_rate == 0.5


def test_delta_solve_pays_one_packed_message():
    s = TorchSolver(device="cpu")
    inp = _inp(40)
    s.solve(to_port(inp))
    full = dict(s.ledger.solve)
    assert full["h2d_arrays"] == len(ARG_SPEC)
    s.solve(to_port(dataclasses.replace(inp, pods=inp.pods[:-3])))
    delta = dict(s.ledger.solve)
    assert s.ledger.outcomes["delta_upload"] == 1
    assert delta["h2d_msgs"] == 1
    assert 1 <= delta["h2d_arrays"] < len(ARG_SPEC)
    assert 0 < delta["h2d_bytes"] < full["h2d_bytes"]


def test_bucket_return_is_exact_hit():
    s = TorchSolver(device="cpu")
    a, b = to_port(_inp(40)), to_port(_inp(60, specs=20, prefix="q"))
    s.solve(a)
    s.solve(b)
    hits = s.arena.stats["exact_hits"]
    s.solve(a)
    assert s.arena.stats["exact_hits"] == hits + 1
    assert s.ledger.solve["h2d_bytes"] == 0


def test_explicit_invalidate_is_safe_anytime():
    s = TorchSolver(device="cpu")
    s.invalidate_arena()
    inp = to_port(_inp(40))
    r1 = s.solve(inp)
    s.invalidate_arena()
    r2 = s.solve(inp)
    assert s.arena.stats["full_uploads"] == 2 and s.arena.stats["invalidations"] == 2
    assert as_data(r1) == as_data(r2)


def test_budget_evicts_whole_cold_buckets():
    """A byte budget of one bucket evicts the other bucket whole; the
    evicted bucket's next solve pays a cold upload and decides the same."""
    s = TorchSolver(device="cpu")
    a, b = to_port(_inp(40)), to_port(_inp(60, specs=20, prefix="q"))
    r1 = s.solve(a)
    s.arena.budget_bytes = s.arena.total_bytes()
    s.solve(b)
    r2 = s.solve(a)
    assert s.arena.stats["evictions"] >= 1
    assert s.ledger.solve["h2d_arrays"] == len(ARG_SPEC)
    assert as_data(r1) == as_data(r2)


def test_ladder_rung_table_resident():
    """A repeated ladder solve re-uploads neither the args nor the rung
    table, as in the JAX backend (same per-solve ledger)."""
    from tests.test_torch_relax import FLEETS

    inp = FLEETS["ladder_schedule_anyway_spreads"]()
    port, tpu = TorchSolver(device="cpu"), TPUSolver()
    for tag in ("cold", "repeat"):
        got = as_data(port.solve(to_port(inp)))
        assert got == as_data(tpu.solve(inp)), tag
        assert port.stats["ladder_solves"] == tpu.stats["ladder_solves"] >= 1
        for k in _LEDGER:
            assert port.ledger.solve[k] == tpu.ledger.solve[k], (tag, k, port.ledger.solve,
                                                                 tpu.ledger.solve)
    assert port.ledger.solve["h2d_bytes"] == 0 and port.arena._ladders


def test_consolidation_universe_adopts_into_its_own_bucket():
    """prepare adopts the universe into the solver's arena under the
    universe tag: a second prepare of the same universe uploads nothing,
    and the universe never shares a bucket with single solves."""
    import chip_smoke
    from karpenter_tpu_torch.disruption.batched import UNIVERSE_TAG, BatchedConsolidationEvaluator

    solver = TorchSolver(device="cpu")
    ev = BatchedConsolidationEvaluator(solver)
    universe = chip_smoke.build_config5_universe(20, 10)
    p1 = ev.prepare(*universe)
    cold = solver.ledger.total["h2d_bytes"]
    assert cold > 0 and all(k[1] == UNIVERSE_TAG for k in solver.arena._buckets)
    p2 = ev.prepare(*universe)
    assert solver.ledger.total["h2d_bytes"] == cold
    assert solver.arena.stats["exact_hits"] == 1
    assert all(a is b for a, b in zip(p1.args, p2.args))
    vs = ev.evaluate_prepared(p2, [[0, 1], list(range(10))])
    assert [v.ok for v in vs] == [True, True]


@pytest.mark.parametrize("name", ["mixed_ladder", "relax_fuzz_0"])
def test_host_relax_loop_adopts_and_resumes_as_jax(name):
    """The host relax loop's dispatches go through the device solve: they
    adopt, harvest and may resume, with the JAX backend's counts."""
    from tests.test_torch_relax import FLEETS

    inp = FLEETS[name]()
    port, tpu = TorchSolver(device="cpu"), TPUSolver()
    assert as_data(port.solve(to_port(inp))) == as_data(tpu.solve(inp))
    assert port.stats["relax_dispatches"] == tpu.stats["relax_dispatches"] > 1
    for k in ("resume_solves", "resume_runs_skipped"):
        assert port.stats[k] == tpu.stats[k], (k, port.stats, tpu.stats)
    assert port.ledger.solves == tpu.ledger.solves
    assert port.ledger.total == {k: tpu.ledger.total[k] for k in port.ledger.total}
    assert port.ledger.outcomes == tpu.ledger.outcomes
