"""The argument arena's upload unpack: the port of
karpenter_tpu/solver/arena.py:230 `_unpack_fn`.

`ArgumentArena.adopt` (solver/arena.py) packs its stale kernel arguments
back to back into one uint8 buffer, at the JAX package's offsets
(`off += a.nbytes`, so an odd-sized bool table leaves the next int32 entry
at an offset that is not a multiple of 4). `upload_packed` stages that
buffer in page-locked host memory, copies it to the device in one
transfer, and `unpack` slices it into typed tensors.

Every `specs` has a launch plan (`unpack_plan`, cached per specs, at most
PLAN_CACHE_MAX, oldest out, as the reference caches its jitted unpack):
each segment's source offset, byte count, dtype and shape, its offset in
ONE output block (a multiple of ALIGN bytes, the int32 and float32
segments first, then the bools), the block's size, and the launcher's
segment table, built once. A call makes one uint8 allocation, the block,
and returns typed views into it (one `as_strided` a segment on a typed
view of the block): every output is contiguous, of the segment's dtype and
shape, and its bytes are what the plain version gives.

- a CUDA buffer goes to the unpack kernel (K8, csrc/arena_kernels.cu), one
  launch that writes every segment into the block;
- a CPU buffer fills the same block from `unpack_plain`, per-segment
  slices.

A call may also MOVE resident tensors into the new block (`moves`: the
arena's survivors of an earlier block that a delta adopt would leave under
half live, solver/arena.py): each is one more segment of the same launch,
read from its device address, so no host byte crosses.

`pad_lanes` pads a lane-stacked argument tuple (the fused cohort's adopted
[n, ...] arrays) to B lanes on the device, lanes past n copies of the last
real one: K16 (csrc/arena_kernels.cu) in one launch for the whole tuple,
or `pad_lanes_plain` for CPU tensors. No host byte crosses.

Each spec is (byte offset, shape, numpy dtype str) in packing order. The
port's tensors follow solver/convert.py: '<i4' and '<u4' entries become
int32 tensors (uint32 as the int32 bit pattern), '<f4' entries (the convex
problem's, solver/convex.py) float32 tensors with the same bits, '|b1'
entries bool tensors read as byte != 0, as the JAX unpack reads them. The
block is a fresh allocation: no output aliases the buffer or a tensor an
enqueued dispatch still reads.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build as _build
from .ffd import _check, _ints, _ptrs, _raise_on, _stream, _u32_scalar

# one count per wrapper call that launches K8 or K16 (see cuda/ffd.py LAUNCHES)
LAUNCHES = {"arena_unpack": 0, "pad_lanes": 0}

_DTYPES = {"<i4": torch.int32, "<u4": torch.int32, "<f4": torch.float32, "|b1": torch.bool}
MAX_SEGS = 64  # csrc/arena_kernels.cu MAX_SEGS: the segment table rides in the launch
MAX_PAD = 64  # csrc/arena_kernels.cu MAX_PAD: K16's array table rides in the launch
ALIGN = 256  # bytes: every segment's offset in the output block is a multiple
PLAN_CACHE_MAX = 64  # plans kept, oldest out (the reference's _UNPACK_CACHE_MAX)
# the block's dtype groups, in block order (int32 and float32 segments are
# whole words; bools fill the block's tail)
_GROUP_ORDER = (torch.int32, torch.float32, torch.bool)
_MOVED = 2  # a segment's kind bit: its source is a device address, not a buffer offset


def _segments(specs):
    """[(offset, nbytes, torch dtype, shape)] of the specs."""
    out = []
    for off, shape, dstr in specs:
        dt = _DTYPES.get(np.dtype(dstr).str)
        if dt is None:
            raise ValueError(f"unpack: unsupported dtype {dstr!r}")
        nb = math.prod(shape) * (1 if dt is torch.bool else 4)
        out.append((int(off), int(nb), dt, tuple(int(s) for s in shape)))
    return out


def aligned(nbytes: int) -> int:
    """`nbytes` rounded up to ALIGN: a segment's footprint in a block."""
    return -(-int(nbytes) // ALIGN) * ALIGN


class BlockLayout:
    """Where typed entries [(nbytes, torch dtype, shape)] sit in one uint8
    block, from byte `base` on: the dtype groups in _GROUP_ORDER, each entry
    at a multiple of ALIGN, its footprint `aligned(nbytes)`. `end` is the
    block's size; `views(block)` cuts the entries' typed views, one
    `as_strided` an entry on a typed view of the block (a tensor op or two
    an entry costs the host more than the launch)."""

    __slots__ = ("dst", "end", "dtypes", "cuts")

    def __init__(self, entries, base: int = 0):
        self.dst = [0] * len(entries)
        off = base
        for dt in _GROUP_ORDER:
            for i, (nb, edt, _) in enumerate(entries):
                if edt is dt:
                    self.dst[i] = off
                    off += aligned(nb)
        self.end = off
        self.dtypes = [dt for dt in _GROUP_ORDER if any(e[1] is dt for e in entries)]
        self.cuts = []  # per entry: (typed view index, shape, contiguous strides, element offset)
        for (nb, dt, shape), d in zip(entries, self.dst):
            strides, acc = [], 1
            for n in reversed(shape):
                strides.append(acc)
                acc *= n
            item = 1 if dt is torch.bool else 4
            self.cuts.append((self.dtypes.index(dt), tuple(shape), tuple(reversed(strides)),
                              d // item))

    def views(self, block: torch.Tensor) -> list:
        typed = [block.view(dt) for dt in self.dtypes]
        return [typed[k].as_strided(shape, strides, off) for k, shape, strides, off in self.cuts]


class UnpackPlan:
    """One `specs`' unpack: the segments (`_segments`), their BlockLayout,
    the block's size, the packed bytes the segments reach (`src_end`), and
    the launcher's segment table for the segments with bytes (`dims`, a
    ctypes int array; `table`, the same ints as a list, for a call that
    appends moved segments)."""

    __slots__ = ("specs", "segs", "layout", "size", "src_end", "table", "dims", "live")

    def __init__(self, specs):
        self.specs = specs
        self.segs = _segments(specs)
        self.layout = BlockLayout([(nb, dt, shape) for _, nb, dt, shape in self.segs])
        self.size = self.layout.end
        self.src_end = max((off + nb for off, nb, _, _ in self.segs), default=0)
        if min((off for off, _, _, _ in self.segs), default=0) < 0:
            raise ValueError("arena_unpack: a segment lies outside the buffer")
        self.live = 0
        table = []
        for (off, nb, dt, _), dst in zip(self.segs, self.layout.dst):
            if nb > 0:
                table += [off, 0, nb, int(dt is torch.bool), dst]
                self.live += 1
        self.table = table
        self.dims = _ints([self.live] + table)

    def views(self, block: torch.Tensor) -> list:
        return self.layout.views(block)


_PLANS: dict = {}


def unpack_plan(specs) -> UnpackPlan:
    """The cached launch plan of `specs` (made on first use; the oldest of
    PLAN_CACHE_MAX goes when a new one comes)."""
    plan = _PLANS.get(specs)
    if plan is None:
        plan = UnpackPlan(specs)
        while len(_PLANS) >= PLAN_CACHE_MAX:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[specs] = plan
    return plan


def unpack_plain(buf: torch.Tensor, specs) -> tuple:
    """Plain PyTorch version: slice each segment out of `buf` (a copy, so
    an unaligned int32 segment views at offset 0), then view it as its
    type; bools are byte != 0."""
    outs = []
    for off, nb, dt, shape in _segments(specs):
        seg = buf[off : off + nb]
        if dt is torch.bool:
            outs.append((seg != 0).reshape(shape))
        else:
            outs.append(seg.clone().view(dt).reshape(shape))
    return tuple(outs)


def _block_for(plan: UnpackPlan, moves, device):
    """The call's one allocation and its views: the plan's segments, then
    the moved tensors (their own layout after the plan's)."""
    if not moves:
        block = torch.empty((plan.size,), dtype=torch.uint8, device=device)
        return block, plan.views(block), [], None
    mlay = BlockLayout([(int(t.nbytes), t.dtype, tuple(t.shape)) for t in moves], plan.size)
    block = torch.empty((mlay.end,), dtype=torch.uint8, device=device)
    return block, plan.views(block), mlay.views(block), mlay


def _launch(ptrs, dims) -> None:
    """One K8 launch over the segment table `dims` into ptrs[1] (the block),
    from ptrs[0] (the packed buffer, or null)."""
    rc = _build.load("arena_kernels").arena_unpack_launch(ptrs, 2, dims, _stream())
    _raise_on(rc, "arena_unpack")
    LAUNCHES["arena_unpack"] += 1


def _unpack_cuda(buf, plan: UnpackPlan, moves, device):
    if buf is not None:
        _check(buf, "buf", torch.uint8)
        if buf.dim() != 1:
            raise ValueError(f"arena_unpack: expected a 1-D buffer, got {tuple(buf.shape)}")
        if plan.src_end > buf.numel():
            raise ValueError("arena_unpack: a segment lies outside the buffer")
        if buf.numel() >= 2**31:
            raise ValueError("arena_unpack: buffers past 2 GiB need 64-bit offsets")
    elif plan.live:
        raise ValueError("arena_unpack: segments to read and no buffer")
    block, outs, moved, mlay = _block_for(plan, moves, device)
    if block.numel() >= 2**31:
        raise ValueError("arena_unpack: blocks past 2 GiB need 64-bit offsets")
    dims, n = plan.dims, plan.live
    if moves:
        table = list(plan.table)
        for t, dst in zip(moves, mlay.dst):
            _check(t, "moved", t.dtype)
            nb = int(t.nbytes)
            if nb > 0:
                addr = t.data_ptr()
                table += [_u32_scalar(addr), addr >> 32, nb, _MOVED | int(t.dtype is torch.bool),
                          dst]
                n += 1
        dims = _ints([n] + table)
    if n > MAX_SEGS:
        raise ValueError(f"arena_unpack: {n} segments > {MAX_SEGS}")
    if n:
        # a call that only moves reads no buffer: its slot is null
        _launch((ctypes.c_void_p * 2)(None if buf is None else buf.data_ptr(), block.data_ptr()),
                dims)
    return tuple(outs), tuple(moved), block


def _unpack_plain_block(buf, plan: UnpackPlan, moves, device):
    """The plan's block filled by the plain version (unpack_plain, copies of
    the moves): the CPU's path, and the card's where a check runs the plain
    versions there. With no buffer (an upload whose stale entries are all
    empty, or a call that only moves) the plan's outputs are left as the
    empty views they are."""
    if buf is None and plan.live:
        raise ValueError("arena_unpack: segments to read and no buffer")
    block, outs, moved, _ = _block_for(plan, moves, device)
    if buf is not None and plan.segs:
        for o, p in zip(outs, unpack_plain(buf, plan.specs)):
            o.copy_(p)
    for o, t in zip(moved, moves):
        o.copy_(t)
    return tuple(outs), tuple(moved), block


def unpack_block(buf, specs, moves=(), device=None):
    """The typed tensors of `specs` sliced from the packed uint8 `buf`, and
    copies of `moves` (resident tensors), all views into one new uint8
    block: (outputs, moved copies, block). The kernel on a CUDA device, the
    plain version on the CPU. `buf` may be None where `specs` is empty (a
    call that only moves); `device` is then the moves' device."""
    plan = unpack_plan(specs)
    dev = buf.device if buf is not None else torch.device(device)
    if dev.type == "cuda":
        return _unpack_cuda(buf, plan, list(moves), dev)
    return _unpack_plain_block(buf, plan, list(moves), dev)


def unpack(buf: torch.Tensor, specs) -> tuple:
    """Typed tensors of `specs` sliced from the packed uint8 `buf`, views
    into one new block: the kernel for a CUDA buffer, the plain version
    for a CPU one."""
    return unpack_block(buf, specs)[0]


def pack(arrays):
    """The arena's packing (the JAX arena.py:697-712): the arrays' bytes
    back to back. Returns (uint8 views in order, total bytes, specs)."""
    specs, parts, off = [], [], 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        specs.append((off, a.shape, a.dtype.str))
        parts.append(a.reshape(-1).view(np.uint8))
        off += a.nbytes
    return parts, off, tuple(specs)


def upload_block(parts, nbytes: int, specs, device, moves=()):
    """Concatenate `parts` (uint8 views of the stale host arrays, packing
    order) into one buffer, move it to `device` in one copy, and unpack it
    into one block with the `moves` (unpack_block). For a CUDA device the
    buffer is staged in page-locked memory taken fresh from PyTorch's
    pinned-host allocator, which records the copy's stream event and reuses
    the block only after the copy has read it, so the non-blocking copy
    never races a later adopt's staging. With no bytes to send nothing is
    staged or copied."""
    device = torch.device(device)
    if nbytes == 0:
        buf = None
    elif device.type == "cuda":
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        np.concatenate(parts, out=host.numpy())
        buf = host.to(device, non_blocking=True)
    else:
        buf = torch.from_numpy(np.concatenate(parts))
    return unpack_block(buf, specs, moves, device)


def upload_packed(parts, nbytes: int, specs, device) -> tuple:
    """upload_block's typed tensors, without moves."""
    return upload_block(parts, nbytes, specs, device)[0]


def pad_lanes_plain(args, batch: int) -> tuple:
    """Plain version: each [n, ...] tensor concatenated with batch - n
    broadcast copies of its last lane."""
    out = []
    for a in args:
        pad = batch - int(a.shape[0])
        out.append(torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]))
    return tuple(out)


def _pad_lanes_cuda(args, batch: int) -> tuple:
    n = int(args[0].shape[0])
    if len(args) > MAX_PAD:
        raise ValueError(f"pad_lanes: {len(args)} arrays > {MAX_PAD}")
    ptrs, dims = [], [len(args), n, int(batch)]
    outs = []
    for i, a in enumerate(args):
        _check(a, f"pad_lanes[{i}]", a.dtype)
        if a.dim() < 1 or int(a.shape[0]) != n:
            raise ValueError(f"pad_lanes[{i}]: expected [{n}, ...], got {tuple(a.shape)}")
        o = torch.empty((batch,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        lane = a.numel() // n * a.element_size()
        ptrs += [a, o]
        dims += [_u32_scalar(lane), lane >> 32]
        outs.append(o)
    rc = _build.load("arena_kernels").pad_lanes_launch(_ptrs(ptrs), len(ptrs), _ints(dims),
                                                       _stream())
    _raise_on(rc, "pad_lanes")
    LAUNCHES["pad_lanes"] += 1
    return tuple(outs)


def pad_lanes(args, batch: int) -> tuple:
    """`args` ([n, ...] tensors, n <= batch) padded to `batch` lanes, lane
    b >= n a copy of lane n - 1: K16 for CUDA tensors, the plain version
    for CPU ones. Every output is a new tensor."""
    if args[0].is_cuda:
        return _pad_lanes_cuda(args, batch)
    return pad_lanes_plain(args, batch)
