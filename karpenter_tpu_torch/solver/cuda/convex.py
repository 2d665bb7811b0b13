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
  (csrc/convex_kernels.cu: a prologue, two launches per iteration, all
  enqueued with no host sync, a one-block tail; one fetch of (X, conv) by
  the caller); a CPU tensor goes to the plain version.

Both return (X [S, N] float32, conv: a 0-d int32 tensor, the 1-based
iteration at which max |dX| first fell under tol, or -1). Every iteration
runs: the result is the LAST iterate, as the JAX scan returns it.
"""

from __future__ import annotations

import numpy as np
import torch

# one count per wrapper call that launches K13 (see cuda/ffd.py LAUNCHES)
LAUNCHES = {"admm_pack": 0}

MAX_R = 16  # csrc/convex_kernels.cu MAX_R: the row's dn sits in shared memory


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


def _admm_pack_cuda(run_req, run_count, cand_cap, cand_cost, feas, tol, max_iters: int):
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
    X = [torch.empty((Sp, Np), dtype=torch.float32, device=dev) for _ in range(2)]
    conv = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(R + 1 + Sp * R + Sp + 2 * Np * R + Np + Sp, dtype=torch.float32,
                          device=dev)
    rc = load("convex_kernels").admm_pack_launch(
        _ptrs([run_req, run_count, cand_cap, cand_cost, feas, tol, X[0], X[1], conv, scratch]),
        10, _ints([Sp, Np, R, max_iters]), _stream())
    _raise_on(rc, "admm_pack")
    LAUNCHES["admm_pack"] += 1
    return X[max_iters % 2], conv.reshape(())


def admm_pack(run_req, run_count, cand_cap, cand_cost, feas, tol, *, max_iters: int):
    """K13 on CUDA tensors, the plain version on CPU ones. `tol` is a float
    or a 1-element float32 tensor on the arguments' device."""
    if feas.is_cuda:
        return _admm_pack_cuda(run_req, run_count, cand_cap, cand_cost, feas, tol,
                               int(max_iters))
    return admm_pack_plain(run_req, run_count, cand_cap, cand_cost, feas, tol, int(max_iters))
