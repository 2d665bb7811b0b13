"""The arena unpack (K8) through its launch plan and one block, on the CPU.

solver/cuda/arena.py keeps a launch plan per `specs` (unpack_plan: at most
PLAN_CACHE_MAX, oldest out, as the JAX package keeps its jitted unpack)
and makes one uint8 block a call, every output a typed view into it at a
multiple of ALIGN bytes; on the CPU the plain version fills the block. The
kernel runs only on the card (chip_smoke.py phase 2d holds it against
unpack_plain there: alignment, no overlap, one allocation a call); here:

- the plan cache: the same specs give the same plan, the 65th distinct
  specs drops the oldest;
- the layout: 256-byte-aligned offsets, no overlap, the block's size, and
  views of the right dtype, shape and contiguity on the block's storage;
- `unpack` through the plan against unpack_plain and the JAX `_unpack_fn`
  on seeded segment lists (odd-sized bool tables in front of int32,
  uint32 and float32 entries; bool bytes 2..255);
- a seeded run of 200 delta adopts over one bucket, the port's
  ArgumentArena(device="cpu") beside the JAX ArgumentArena: after every
  adopt the bytes the bucket's blocks hold stay within twice its live
  entries' footprints (each entry's bytes rounded up to ALIGN), the
  entries equal the host arrays, and the ledger and the budget's accounting
  equal the JAX arena's; a streaming edit (K14's plain version) that
  leaves a block under half live moves its survivors out;
- a placed (mesh-sharded) bucket over seeded delta adopts holds the same
  bound, and survivors on a device that no stale group uploads to move
  with a launch that only moves;
- an upload whose stale entries are all empty sends no buffer and gives
  empty views of the right dtype and shape.

Tolerance: exact equality (bytes and integer counts).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import arena as jarena
from karpenter_tpu.solver.arena import _unpack_fn
from karpenter_tpu_torch.parallel.sharded import Mesh, Placement, make_mesh, virtual_devices
from karpenter_tpu_torch.solver import arena as tarena
from karpenter_tpu_torch.solver.cuda import arena as tunpack
from tests.test_torch_arena import _pack, _segment_list
from tests.test_torch_jax_release import release_if_crowded

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax():
    yield
    release_if_crowded()


@pytest.fixture
def fresh_plans(monkeypatch):
    """An empty plan cache for the test."""
    monkeypatch.setattr(tunpack, "_PLANS", {})
    return tunpack._PLANS


def _float_list(seed: int):
    """_segment_list's entries with float32 ones among them, behind
    odd-sized bools too."""
    rng = np.random.default_rng(100 + seed)
    out = _segment_list(seed)
    for i in range(2):
        out.insert(2 * i + 1, rng.standard_normal((int(rng.integers(1, 9)),)).astype(np.float32))
        out.insert(2 * i + 1, rng.random((int(rng.integers(1, 4)) * 2 + 1,)) < 0.5)
    return out


# ----------------------------------------------------------- the plan cache


def test_same_specs_same_plan(fresh_plans):
    _, specs = _pack(_segment_list(0))
    plan = tunpack.unpack_plan(specs)
    assert tunpack.unpack_plan(tuple(specs)) is plan and len(fresh_plans) == 1
    assert plan.specs == specs and len(plan.segs) == len(specs)


def test_the_65th_specs_drops_the_oldest(fresh_plans):
    specs = [((0, (n,), "<i4"),) for n in range(1, tunpack.PLAN_CACHE_MAX + 2)]
    plans = [tunpack.unpack_plan(s) for s in specs]
    assert tunpack.PLAN_CACHE_MAX == 64 == len(fresh_plans)
    assert specs[0] not in fresh_plans and all(s in fresh_plans for s in specs[1:])
    assert tunpack.unpack_plan(specs[-1]) is plans[-1]
    assert tunpack.unpack_plan(specs[0]) is not plans[0]  # made again
    assert specs[1] not in fresh_plans and len(fresh_plans) == 64


# ---------------------------------------------------------------- the layout


@pytest.mark.parametrize("seed", range(4))
def test_layout_aligned_without_overlap(seed, fresh_plans):
    arrays = _float_list(seed)
    buf, specs = _pack(arrays)
    plan = tunpack.unpack_plan(specs)
    spans = sorted((d, d + nb) for d, (_, nb, _, _) in zip(plan.layout.dst, plan.segs))
    assert all(lo % tunpack.ALIGN == 0 for lo, _ in spans)
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    assert plan.size == sum(tunpack.aligned(nb) for _, nb, _, _ in plan.segs)
    assert plan.size % tunpack.ALIGN == 0 and spans[-1][1] <= plan.size
    outs, moved, block = tunpack.unpack_block(torch.from_numpy(buf.copy()), specs)
    assert moved == () and block.dtype == torch.uint8 and block.numel() == plan.size
    base = block.data_ptr()
    for o, (_, shape, dstr), d in zip(outs, specs, plan.layout.dst):
        assert o.dtype == tunpack._DTYPES[np.dtype(dstr).str] and tuple(o.shape) == tuple(shape)
        assert o.is_contiguous() and o.data_ptr() - base == d
        assert o.untyped_storage().data_ptr() == block.untyped_storage().data_ptr()
    # the launcher's table: one row of five a segment with bytes
    live = [s for s in plan.segs if s[1] > 0]
    assert plan.live == len(live) and len(plan.table) == 5 * len(live)
    assert list(plan.dims)[0] == len(live)


# ------------------------------------------------- the values against JAX


def _check_against_jax(buf: np.ndarray, specs):
    want = _unpack_fn(specs, None)(buf)
    got = tunpack.unpack(torch.from_numpy(buf.copy()), specs)
    plain = tunpack.unpack_plain(torch.from_numpy(buf.copy()), specs)
    for (off, shape, dstr), w, g, p in zip(specs, want, got, plain):
        w = np.asarray(w)
        assert g.dtype == p.dtype and tuple(g.shape) == tuple(p.shape) == tuple(shape)
        assert torch.equal(g, p), (off, shape, dstr)
        gn = g.numpy()
        if dstr == "<u4":
            gn = gn.view(np.uint32)
        assert w.dtype == gn.dtype and w.tobytes() == gn.tobytes(), (off, shape, dstr)


@pytest.mark.parametrize("seed", range(6))
def test_planned_unpack_matches_plain_and_jax(seed):
    buf, specs = _pack(_float_list(seed))
    assert any(off % 4 for off, _, d in specs if d in ("<i4", "<u4", "<f4"))
    assert {d for _, _, d in specs} == {"<i4", "<u4", "<f4", "|b1"}
    _check_against_jax(buf, specs)


@pytest.mark.parametrize("seed", range(3))
def test_planned_unpack_bool_bytes_2_to_255(seed):
    buf, specs = _pack(_float_list(10 + seed))
    rng = np.random.default_rng(seed)
    for off, shape, dstr in specs:
        if dstr == "|b1":
            n = int(np.prod(shape))
            buf[off:off + n] = rng.integers(0, 256, size=n, dtype=np.uint8)
    assert any(buf[off] >= 2 for off, _, d in specs if d == "|b1")
    _check_against_jax(buf, specs)


def test_moves_land_in_the_block():
    """A call that also moves resident tensors: they follow the plan's
    segments in the same block, equal to what they were; a call that only
    moves needs no buffer."""
    buf, specs = _pack(_segment_list(2))
    moves = [torch.arange(7, dtype=torch.int32), torch.tensor([True, False, True]),
             torch.ones((2, 3), dtype=torch.float32)]
    outs, moved, block = tunpack.unpack_block(torch.from_numpy(buf.copy()), specs, moves)
    plan = tunpack.unpack_plan(specs)
    assert block.numel() == plan.size + sum(tunpack.aligned(t.nbytes) for t in moves)
    for m, t in zip(moved, moves):
        assert torch.equal(m, t) and (m.data_ptr() - block.data_ptr()) % tunpack.ALIGN == 0
        assert m.data_ptr() - block.data_ptr() >= plan.size
    _, moved2, block2 = tunpack.upload_block([], 0, (), "cpu", moves=moves)
    assert all(torch.equal(m, t) for m, t in zip(moved2, moves))
    assert block2.numel() == sum(tunpack.aligned(t.nbytes) for t in moves)


# ------------------------------------------- the bound over delta adopts


def _storage_bytes(dev) -> int:
    """Bytes of the distinct storages behind the bucket's entries."""
    seen = {}
    for t in dev:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _entries_equal(dev, host):
    for t, h in zip(dev, host):
        g = t.numpy()
        assert g.shape == h.shape
        assert np.array_equal(g.view(h.dtype) if h.dtype != np.bool_ else g, h)


def test_200_delta_adopts_hold_the_bound_and_the_ledger():
    rng = np.random.default_rng(18)
    host = [rng.integers(-9, 9, (40, 3)).astype(np.int32),
            rng.random(13) < 0.5,
            rng.integers(0, 2**32, (5,), dtype=np.uint64).astype(np.uint32),
            rng.integers(-9, 9, (700,)).astype(np.int32),
            rng.random((3, 7)) < 0.5,
            rng.standard_normal((64,)).astype(np.float32),
            rng.integers(-9, 9, (2, 2)).astype(np.int32)]
    prov = (None,) * len(host)
    port, ref = tarena.ArgumentArena(device="cpu"), jarena.ArgumentArena()
    moved_any, dev = 0, ()
    for step in range(200):
        if step:
            n = 1 if rng.random() < 0.7 else int(rng.integers(2, 4))
            for i in rng.choice(len(host), size=n, replace=False):
                a = host[i].copy()
                flat = a.reshape(-1)
                j = int(rng.integers(0, flat.size))
                flat[j] = ~flat[j] if a.dtype == np.bool_ else flat[j] + 1
                host[i] = a
        prev = [t.data_ptr() for t in dev] if step else []
        dev = port.adopt(tuple(host), prov)
        ref.adopt(tuple(host), prov)
        key = port.bucket_key(tuple(host))
        _entries_equal(dev, host)
        live = sum(tunpack.aligned(t.nbytes) for t in dev)
        held = port.block_bytes(key)
        assert held == _storage_bytes(dev), (step, held)
        assert held <= 2 * live, (step, held, live)
        assert port.ledger.total == {k: ref.ledger.total[k] for k in port.ledger.total}, step
        assert port.ledger.outcomes == ref.ledger.outcomes, step
        assert port.total_bytes() == ref.total_bytes() and port.last_stale == ref.last_stale
        # a survivor of an earlier block that moved into this adopt's block
        moved_any += any(i not in port.last_stale and t.data_ptr() != p
                         for i, (t, p) in enumerate(zip(dev, prev)))
    assert port.stats["delta_uploads"] == 199 and port.stats["exact_hits"] == 0
    assert moved_any > 0
    port.invalidate()
    assert not port._homes and not port._blocks


def test_streaming_edit_moves_the_survivors():
    """K14 (here its plain version) replaces the run tables outside any
    block; where that leaves their block under half live, its survivors
    move into a block of their own (a launch that only moves), and the
    bound holds."""
    rng = np.random.default_rng(3)
    Sp = 512
    rg = np.arange(Sp, dtype=np.int32)
    rc = rng.integers(0, 9, Sp).astype(np.int32)
    small = rng.integers(0, 9, 10).astype(np.int32)
    host = (rg, rc, small)
    prov = ("rg0", "rc0", "small")
    ar = tarena.ArgumentArena(device="cpu")
    assert not ar.apply_run_events(host, prov)  # records the base
    dev = ar.adopt(host, prov)
    key = ar.bucket_key(host)
    (b0,) = set(ar._blocks[key])
    rc2 = rc.copy()
    rc2[5] += 1
    host2 = (rg, rc2, small)
    assert ar.apply_run_events(host2, ("rg0", "rc1", "small"))
    dev = ar._buckets[key][0]
    _entries_equal(dev, host2)
    assert b0 not in ar._blocks[key], "the half-empty block stayed"
    live = sum(tunpack.aligned(t.nbytes) for t in dev)
    assert ar.block_bytes(key) == _storage_bytes(dev) <= 2 * live
    ar.adopt(host2, ("rg0", "rc1", "small"))
    assert ar.last_stale == () and ar.stats["exact_hits"] == 1


def _placed_storage_bytes(dev) -> int:
    """Bytes of the distinct storages behind a placed bucket's tensors."""
    return _storage_bytes([t for x in dev for t in x])


def _placed_equal(dev, host, placements):
    for x, h, plc in zip(dev, host, placements):
        for j, t in enumerate(x):
            want = h[plc.mesh.local_slots(j)] if plc.blocked else h
            g = t.numpy()
            assert np.array_equal(g.view(want.dtype) if want.dtype != np.bool_ else g, want)


def test_sharded_delta_adopts_hold_the_bound():
    """A placed bucket (blocked and copied entries on a 4-slot mesh) over
    100 seeded delta adopts: the blocks stay within twice the live
    footprints, the entries equal the host arrays (each device its slots'
    rows), and survivors moved."""
    rng = np.random.default_rng(7)
    with virtual_devices(4):
        mesh = make_mesh(4, device="cpu")
        host = [rng.integers(-9, 9, (8, 90)).astype(np.int32),
                rng.random((4, 13)) < 0.5,
                rng.integers(-9, 9, (4, 3)).astype(np.int32),
                rng.standard_normal((300,)).astype(np.float32),
                rng.random(7) < 0.5,
                rng.integers(-9, 9, (8,)).astype(np.int32)]
        placements = tuple(Placement(mesh, blocked) for blocked in
                           (True, True, True, False, False, True))
        prov = (None,) * len(host)
        port = tarena.ArgumentArena(device="cpu")
        for step in range(100):
            if step:
                for i in rng.choice(len(host), size=int(rng.integers(1, 3)), replace=False):
                    a = host[i].copy()
                    flat = a.reshape(-1)
                    j = int(rng.integers(0, flat.size))
                    flat[j] = ~flat[j] if a.dtype == np.bool_ else flat[j] + 1
                    host[i] = a
            dev = port.adopt(tuple(host), prov, sharding=placements)
            key = port.bucket_key(tuple(host), placements)
            _placed_equal(dev, host, placements)
            held = port.block_bytes(key)
            assert held == _placed_storage_bytes(dev), step
            assert held <= 2 * port.live_bytes(key), (step, held, port.live_bytes(key))
        assert port.stats["moved_segments"] > 0 and port.stats["compactions"] > 0, port.stats


def test_sharded_survivors_off_every_stale_mesh_move():
    """A survivor whose device no stale group's mesh reaches still moves
    out of a block left under half live (a launch that only moves): here
    the stale group's mesh names cpu:0, which no tensor's device equals,
    as a second card's would not."""
    big = np.arange(2000, dtype=np.int32)
    small = np.arange(3, dtype=np.int32)
    other = np.arange(5, dtype=np.int32)
    host = (other, big, small)
    placements = (Placement(Mesh(["cpu"], "a"), False),
                  Placement(Mesh([torch.device("cpu", 0)], "b"), False),
                  Placement(Mesh([torch.device("cpu", 0)], "b"), False))
    port = tarena.ArgumentArena(device="cpu")
    port.adopt(host, ("o", "b0", "s"), sharding=placements)
    key = port.bucket_key(host, placements)
    assert port.stats["compactions"] == 0 and len(port._blocks[key]) == 2
    big2 = big + 1
    dev = port.adopt((other, big2, small), ("o", "b1", "s"), sharding=placements)
    assert port.last_stale == (1,)
    assert port.stats["moved_segments"] == 1 and port.stats["compactions"] == 1, port.stats
    _placed_equal(dev, (other, big2, small), placements)
    held = port.block_bytes(key)
    assert held == _placed_storage_bytes(dev) <= 2 * port.live_bytes(key)
    assert len(port._blocks[key]) == 3  # other's, big's new one, small's own


def test_upload_of_empty_stale_entries():
    """Stale entries that are all empty send no buffer: the outputs are
    empty views of the right dtype and shape, in an empty block; an arena
    adopt of such entries equals the JAX arena's ledger."""
    arrays = [np.zeros((0,), np.int32), np.zeros((0, 3), np.bool_),
              np.zeros((2, 0), np.float32), np.zeros((0,), np.uint32)]
    parts, nbytes, specs = tunpack.pack(arrays)
    assert nbytes == 0
    outs, moved, block = tunpack.upload_block(parts, nbytes, specs, "cpu")
    assert moved == () and block.numel() == 0
    for o, a in zip(outs, arrays):
        assert tuple(o.shape) == a.shape and o.numel() == 0
        assert o.dtype == tunpack._DTYPES[a.dtype.str]
    assert [tuple(o.shape) for o in tunpack.upload_packed(parts, nbytes, specs, "cpu")] == \
        [a.shape for a in arrays]
    with pytest.raises(ValueError, match="no buffer"):
        tunpack.unpack_block(None, tunpack.pack([np.ones(2, np.int32)])[2], device="cpu")
    port, ref = tarena.ArgumentArena(device="cpu"), jarena.ArgumentArena()
    prov = (None,) * len(arrays)
    dev = port.adopt(tuple(arrays), prov)
    ref.adopt(tuple(arrays), prov)
    assert [tuple(t.shape) for t in dev] == [a.shape for a in arrays]
    assert port.ledger.total == {k: ref.ledger.total[k] for k in port.ledger.total}
    assert port.block_bytes(port.bucket_key(tuple(arrays))) == 0
