"""Carry state across the two packages as numpy.

Karpenter has no weights: what crosses between the JAX reference and the
port is the encoded kernel arguments (host_kernel_args' numpy tuple, the
same from either package) and the scan state. uint32 arrays travel into
torch as int32 views of the same bits and come back as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.ffd import FFDOutput, FFDState

# FFDState fields that the JAX scan carries as uint32
_U32_STATE = frozenset({"c_zc_bits", "c_gbits"})


def array_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """One numpy kernel argument -> a torch tensor on `device` (uint32 ->
    int32 bit pattern; bool and int32 keep their type)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.bool_:
        a = a.astype(np.int32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def args_to_torch(host_args, device) -> tuple:
    """host_kernel_args' numpy tuple -> the port's tensors, ARG_SPEC order."""
    return tuple(array_to_torch(a, device) for a in host_args)


def state_to_numpy(state: FFDState) -> dict:
    """FFDState -> {field: numpy} with the JAX dtypes (uint32 restored)."""
    out = {}
    for name, t in state._asdict().items():
        a = t.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_STATE else a
    return out


def output_to_numpy(out: FFDOutput) -> dict:
    """FFDOutput -> {take_e, take_c, leftover, state: {...}} as numpy."""
    return {
        "take_e": out.take_e.cpu().numpy(),
        "take_c": out.take_c.cpu().numpy(),
        "leftover": out.leftover.cpu().numpy(),
        "state": state_to_numpy(out.state),
    }
