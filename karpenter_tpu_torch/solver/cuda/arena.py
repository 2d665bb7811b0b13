"""The argument arena's upload unpack: the port of
karpenter_tpu/solver/arena.py:230 `_unpack_fn`.

`ArgumentArena.adopt` (solver/arena.py) packs its stale kernel arguments
back to back into one uint8 buffer, at the JAX package's offsets
(`off += a.nbytes`, so an odd-sized bool table leaves the next int32 entry
at an offset that is not a multiple of 4). `upload_packed` stages that
buffer in page-locked host memory, copies it to the device in one
transfer, and `unpack` slices it into typed tensors:

- a CUDA buffer goes to the unpack kernel (K8, csrc/arena_kernels.cu), one
  launch over the whole segment table;
- a CPU buffer goes to `unpack_plain`, per-segment slices.

`pad_lanes` pads a lane-stacked argument tuple (the fused cohort's adopted
[n, ...] arrays) to B lanes on the device, lanes past n copies of the last
real one: K16 (csrc/arena_kernels.cu) in one launch for the whole tuple,
or `pad_lanes_plain` for CPU tensors. No host byte crosses.

Each spec is (byte offset, shape, numpy dtype str) in packing order. The
port's tensors follow solver/convert.py: '<i4' and '<u4' entries become
int32 tensors (uint32 as the int32 bit pattern), '<f4' entries (the convex
problem's, solver/convex.py) float32 tensors with the same bits, '|b1'
entries bool tensors read as byte != 0, as the JAX unpack reads them. Every output is a freshly
allocated tensor: none aliases the buffer or a tensor an enqueued dispatch
still reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# one count per wrapper call that launches K8 or K16 (see cuda/ffd.py LAUNCHES)
LAUNCHES = {"arena_unpack": 0, "pad_lanes": 0}

_DTYPES = {"<i4": torch.int32, "<u4": torch.int32, "<f4": torch.float32, "|b1": torch.bool}
MAX_SEGS = 64  # csrc/arena_kernels.cu MAX_SEGS: the segment table rides in the launch
MAX_PAD = 64  # csrc/arena_kernels.cu MAX_PAD: K16's array table rides in the launch


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


def _unpack_cuda(buf: torch.Tensor, specs) -> tuple:
    from .build import load
    from .ffd import _check, _ints, _ptrs, _raise_on, _stream

    _check(buf, "buf", torch.uint8)
    if buf.dim() != 1:
        raise ValueError(f"arena_unpack: expected a 1-D buffer, got {tuple(buf.shape)}")
    segs = _segments(specs)
    if any(off < 0 or off + nb > buf.numel() for off, nb, _, _ in segs):
        raise ValueError("arena_unpack: a segment lies outside the buffer")
    if buf.numel() >= 2**31:
        raise ValueError("arena_unpack: buffers past 2 GiB need 64-bit offsets")
    outs = [torch.empty(shape, dtype=dt, device=buf.device) for _, _, dt, shape in segs]
    live = [(s, o) for s, o in zip(segs, outs) if s[1] > 0]
    if not live:
        return tuple(outs)
    if len(live) > MAX_SEGS:
        raise ValueError(f"arena_unpack: {len(live)} segments > {MAX_SEGS}")
    ptrs = [buf] + [o for _, o in live]
    dims = [len(live)]
    for (off, nb, dt, _), _o in live:
        dims += [off, nb, int(dt is torch.bool)]
    rc = load("arena_kernels").arena_unpack_launch(
        _ptrs(ptrs), len(ptrs), _ints(dims), _stream())
    _raise_on(rc, "arena_unpack")
    LAUNCHES["arena_unpack"] += 1
    return tuple(outs)


def unpack(buf: torch.Tensor, specs) -> tuple:
    """Typed tensors of `specs` sliced from the packed uint8 `buf`: the
    kernel for a CUDA buffer, the plain version for a CPU one."""
    if buf.is_cuda:
        return _unpack_cuda(buf, specs)
    return unpack_plain(buf, specs)


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


def upload_packed(parts, nbytes: int, specs, device) -> tuple:
    """Concatenate `parts` (uint8 views of the stale host arrays, packing
    order) into one buffer, move it to `device` in one copy, and unpack
    it. For a CUDA device the buffer is staged in page-locked memory taken
    fresh from PyTorch's pinned-host allocator, which records the copy's
    stream event and reuses the block only after the copy has read it, so
    the non-blocking copy never races a later adopt's staging."""
    device = torch.device(device)
    if device.type == "cuda":
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        np.concatenate(parts, out=host.numpy())
        buf = host.to(device, non_blocking=True)
    else:
        buf = torch.from_numpy(np.concatenate(parts))
    return unpack(buf, specs)


def pad_lanes_plain(args, batch: int) -> tuple:
    """Plain version: each [n, ...] tensor concatenated with batch - n
    broadcast copies of its last lane."""
    out = []
    for a in args:
        pad = batch - int(a.shape[0])
        out.append(torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]))
    return tuple(out)


def _pad_lanes_cuda(args, batch: int) -> tuple:
    from .build import load
    from .ffd import _check, _ints, _ptrs, _raise_on, _u32_scalar, _stream

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
    rc = load("arena_kernels").pad_lanes_launch(_ptrs(ptrs), len(ptrs), _ints(dims), _stream())
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
