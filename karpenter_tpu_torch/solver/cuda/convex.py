"""The convex backend's device program: the port of
karpenter_tpu/solver/convex.py:124 `admm_pack` (K13).

Float32 entropic mirror descent over a fractional assignment X[S, N]: per
iteration the column load X^T dn, the capacity overload, a per-row
normalised gradient, a multiplicative-weights step with an annealed step
size, geometric damping, and a latch of the first iteration whose max |dX|
falls under `tol` (solver/convex.py describes the problem and its columns).

- `admm_pack_plain`: the plain PyTorch version, the JAX body written out
  (the CPU tests hold it against the JAX function; chip_smoke.py holds the
  kernel against it on the card);
- `admm_pack`: the wrapper. A CUDA tensor goes to the kernel
  (csrc/convex_kernels.cu: one persistent cooperative launch over the
  feasible cells, which builds their row and column layout on the card,
  runs the iterations between grid barriers and writes the dense X; one
  fetch of (X, conv) by the caller); a CPU tensor goes to the plain version;
- `admm_layout_plain`: the plain version of the kernel's feasible-cell
  layout (CSR by row, CSC by column as positions into the CSR), for the
  tests and chip_smoke.py's check of the kernel's own buffers.

Both return (X [S, N] float32, conv: a 0-d int32 tensor, the 1-based
iteration at which max |dX| first fell under tol, or -1). Every iteration
runs: the result is the LAST iterate, as the JAX scan returns it.
"""

from __future__ import annotations

import numpy as np
import torch

# one count per wrapper call that launches K13 (see cuda/ffd.py LAUNCHES)
LAUNCHES = {"admm_pack": 0}

MAX_R = 16  # csrc/convex_kernels.cu MAX_R: a lane's load sums and a row's dn sit in registers
# the kernel's narrow instance (int32 positions into its layout, 16-bit
# column, row and rank indices) takes tables of at most WIDE_CELLS cells
# and NARROW_DIM rows and columns; the wide one (int64 positions, int32
# indices) every other
WIDE_CELLS = 2**31 - 1
NARROW_DIM = 65_535


def _f32(v) -> float:
    return float(np.float32(v))


def admm_pack_plain(run_req, run_count, cand_cap, cand_cost, feas, tol, max_iters: int):
    """Plain PyTorch version of the JAX admm_pack (convex.py:143-193), op
    for op in float32; the scalar schedule (eta, beta) in numpy float32 from
    the int iteration index, as the scan computes it."""
    from ..convex import _ANNEAL, _ETA0, _ETA_MAX, _RHO, _TAU

    f32 = torch.float32
    dev = feas.device
    req = run_req.to(f32)
    cnt = run_count.to(f32)
    cap = cand_cap.to(f32)
    cost = cand_cost.to(f32)
    demand = req * cnt[:, None]
    ref = torch.clamp(cap.amax(dim=0), min=1.0)
    dn = demand / ref[None, :]
    capn = cap / ref[None, :]
    size = torch.clamp(dn.sum(dim=1), min=1e-6)
    costn = cost / torch.clamp(cost.abs().amax(), min=1e-6)
    maskf = feas.to(f32)
    X = maskf / torch.clamp(maskf.sum(dim=1, keepdim=True), min=1.0)
    tolv = torch.as_tensor(tol, dtype=f32, device=dev).reshape(())
    conv = torch.full((), -1, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    for i in range(int(max_iters)):
        fi = np.float32(i)
        load = X.T @ dn
        over = torch.clamp(load - capn, min=0.0)
        grad = costn[None, :] * size[:, None] + _RHO * (dn @ over.T)
        gmin = torch.where(feas, grad, inf).amin(dim=1, keepdim=True)
        g = torch.where(feas, grad - gmin, 0.0)
        gmax = torch.clamp(g.amax(dim=1, keepdim=True), min=1e-9)
        eta = min(np.float32(_ETA0) * (np.float32(1.0) + fi / np.float32(_ANNEAL)),
                  np.float32(_ETA_MAX))
        W = torch.where(feas, X * torch.exp(_f32(-eta) * g / gmax), 0.0)
        Z = W.sum(dim=1, keepdim=True)
        Xm = torch.where(Z > 0, W / torch.clamp(Z, min=1e-30), 0.0)
        beta = np.float32(0.5) * np.exp2(-fi / np.float32(_TAU))
        Xn = _f32(np.float32(1.0) - beta) * X + _f32(beta) * Xm
        resid = (Xn - X).abs().amax()
        conv = torch.where((conv < 0) & (resid < tolv), torch.full_like(conv, i + 1), conv)
        X = Xn
    return X, conv


LAYOUT_FIELDS = ("row_ptr", "col", "tptr", "trow", "tmask", "tbase")


def admm_layout_plain(feas):
    """The kernel's layout of the feasible cells of `feas` [Sp, Np], as
    int64 tensors on its device, in LAYOUT_FIELDS' order: the CSR (row_ptr
    [Sp + 1]; col [nnz], each row's feasible columns in ascending order)
    and the column tiles (32 adjacent columns; tile t's entries tptr[t] to
    tptr[t + 1], one a row with a feasible cell in the tile, in ascending
    row order: trow, the row; tmask, bit l set where cell (row, 32 t + l)
    is feasible; tbase, the CSR position of the row's first feasible cell
    in the tile)."""
    i64 = torch.int64
    Sp, Np = feas.shape
    tiles = -(-Np // 32)
    dev = feas.device
    _, cols = feas.nonzero(as_tuple=True)  # row-major: rows, then columns, ascending
    row_ptr = torch.zeros(Sp + 1, dtype=i64, device=dev)
    row_ptr[1:] = feas.sum(dim=1).cumsum(0)
    cells = torch.zeros((Sp, tiles * 32), dtype=i64, device=dev)
    cells[:, :Np] = feas.to(i64)
    cells = cells.view(Sp, tiles, 32)
    mask = (cells << torch.arange(32, dtype=i64, device=dev)).sum(dim=2)  # [Sp, tiles]
    before = cells.sum(dim=2).cumsum(dim=1) - cells.sum(dim=2)  # the row's cells before a tile
    t_idx, s_idx = (mask.T != 0).nonzero(as_tuple=True)  # tile-major, rows ascending
    tptr = torch.zeros(tiles + 1, dtype=i64, device=dev)
    tptr[1:] = (mask != 0).sum(dim=0).cumsum(0)
    return (row_ptr, cols.to(i64), tptr, s_idx.to(i64), mask[s_idx, t_idx],
            row_ptr[s_idx] + before[s_idx, t_idx])


def _wide(Sp: int, Np: int) -> bool:
    return Sp * Np > WIDE_CELLS or max(Sp, Np) > NARROW_DIM


def kernel_info(Sp: int, Np: int, R: int, device=None) -> dict:
    """The launch K13 makes for a table of Sp x Np cells and R resources on
    `device` (the current CUDA device by default): scratch bytes, grid
    blocks, threads a block, blocks a multiprocessor, multiprocessors, warps
    of a row team, grid barriers an iteration, the position type's bytes."""
    import ctypes

    from .build import load

    wide = _wide(Sp, Np)
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = load("convex_kernels").admm_info((ctypes.c_void_p * 1)(ctypes.addressof(out)), 1,
                                              (ctypes.c_int * 5)(Sp, Np, R, 0, int(wide)), None)
    if rc != 0:
        raise RuntimeError(f"admm_info: CUDA error {rc}")
    keys = ("scratch_bytes", "grid", "threads", "blocks_per_sm", "sms", "team_warps",
            "barriers_per_iteration")
    return dict(zip(keys, (int(v) for v in out)), position_bytes=8 if wide else 4)


def _admm_pack_cuda(run_req, run_count, cand_cap, cand_cost, feas, tol, max_iters: int,
                    layout=None):
    """K13. With a dict `layout`, the call's layout is stored in it
    (LAYOUT_FIELDS as int64, cut to their lengths, and Xc; a host sync), for
    chip_smoke.py's check against admm_layout_plain."""
    from .build import load
    from .ffd import _check, _ints, _ptrs, _raise_on, _stream

    if run_req.dim() != 2 or feas.dim() != 2:
        raise ValueError("admm_pack: run_req and feas must be 2-D")
    Sp, R = run_req.shape
    Np = feas.shape[1]
    if not (1 <= R <= MAX_R) or Sp < 1 or Np < 1:
        raise ValueError(f"admm_pack: R={R} outside 1..{MAX_R}, or an empty S={Sp} / N={Np}")
    if max_iters < 0:
        raise ValueError(f"admm_pack: max_iters={max_iters} < 0")
    dev = feas.device
    if not torch.is_tensor(tol):
        tol = torch.full((1,), _f32(tol), dtype=torch.float32, device=dev)
    for t, n, dt, shape in ((run_req, "run_req", torch.float32, (Sp, R)),
                            (run_count, "run_count", torch.int32, (Sp,)),
                            (cand_cap, "cand_cap", torch.float32, (Np, R)),
                            (cand_cost, "cand_cost", torch.float32, (Np,)),
                            (feas, "feas", torch.bool, (Sp, Np)),
                            (tol, "tol", torch.float32, (1,))):
        _check(t, n, dt, shape)
    info = kernel_info(Sp, Np, R, dev)
    wide = info["position_bytes"] == 8
    cells = Sp * Np
    ptype = torch.int64 if wide else torch.int32
    tiles = -(-Np // 32)
    X = torch.empty((Sp, Np), dtype=torch.float32, device=dev)
    conv = torch.empty(1, dtype=torch.int32, device=dev)
    # the layout, sized for the dense worst case: X and its columns (CSR;
    # the narrow kernel reads the columns as uint16), the column tiles'
    # entries; then the small arrays
    Xc = torch.empty(cells, dtype=torch.float32, device=dev)
    col = torch.empty(cells, dtype=torch.int32 if wide else torch.int16, device=dev)
    tptr = torch.empty(tiles + 1, dtype=ptype, device=dev)
    trow = torch.empty(Sp * tiles, dtype=torch.int32, device=dev)
    tmask = torch.empty(Sp * tiles, dtype=torch.int32, device=dev)  # uint32 bits
    tbase = torch.empty(Sp * tiles, dtype=ptype, device=dev)
    scratch = torch.empty(info["scratch_bytes"], dtype=torch.uint8, device=dev)
    rc = load("convex_kernels").admm_pack_launch(
        _ptrs([run_req, run_count, cand_cap, cand_cost, feas, tol, X, conv, Xc, col, tptr, trow,
               tmask, tbase, scratch]),
        15, _ints([Sp, Np, R, max_iters, int(wide)]), _stream())
    _raise_on(rc, "admm_pack")
    LAUNCHES["admm_pack"] += 1
    if layout is not None:
        row_ptr = scratch[: (Sp + 1) * info["position_bytes"]].view(ptype)  # opens the scratch
        nnz, entries = int(row_ptr[-1]), int(tptr[-1])
        i64 = torch.int64
        layout.update(row_ptr=row_ptr.to(i64),
                      col=col[:nnz].to(i64) & (0xFFFF if not wide else -1), tptr=tptr.to(i64),
                      trow=trow[:entries].to(i64), tmask=tmask[:entries].to(i64) & 0xFFFFFFFF,
                      tbase=tbase[:entries].to(i64), Xc=Xc[:nnz])
    return X, conv.reshape(())


def admm_pack(run_req, run_count, cand_cap, cand_cost, feas, tol, *, max_iters: int):
    """K13 on CUDA tensors, the plain version on CPU ones. `tol` is a float
    or a 1-element float32 tensor on the arguments' device."""
    if feas.is_cuda:
        return _admm_pack_cuda(run_req, run_count, cand_cap, cand_cost, feas, tol,
                               int(max_iters))
    return admm_pack_plain(run_req, run_count, cand_cap, cand_cost, feas, tol, int(max_iters))
