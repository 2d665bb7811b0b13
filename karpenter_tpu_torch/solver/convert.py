"""Carry state across the two packages as numpy.

Karpenter has no weights: what crosses between the JAX reference and the
port is the encoded kernel arguments (host_kernel_args' numpy tuple, the
same from either package), the scan state and its checkpoint ring (a JAX
FFDState or CheckpointRing read as numpy, so a resume can start from a
JAX ring slot), and the convex backend's problem (a JAX `_Problem`, whose
fields are numpy). uint32 arrays travel into torch as int32 views of the same
bits and come back as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.ffd import CheckpointRing, FFDOutput, FFDState

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
    # ascontiguousarray lifts a 0-d array to 1-d; the reshape keeps its shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape).to(device)


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


def output_to_host(out: FFDOutput) -> FFDOutput:
    """A fetched FFDOutput: every field a numpy array with the port's
    dtypes (uint32 words stay int32 bit patterns)."""
    return FFDOutput(take_e=out.take_e.cpu().numpy(), take_c=out.take_c.cpu().numpy(),
                     leftover=out.leftover.cpu().numpy(),
                     state=FFDState(*(f.cpu().numpy() for f in out.state)),
                     events=out.events.cpu().numpy())


def state_to_torch(state, device) -> FFDState:
    """An FFDState of arrays (the JAX package's, or state_to_numpy's dict)
    -> the port's FFDState on `device`."""
    get = state.get if isinstance(state, dict) else (lambda n: getattr(state, n))
    return FFDState(**{n: array_to_torch(np.array(get(n)), device) for n in FFDState._fields})


def ring_to_torch(ring, device) -> CheckpointRing:
    """A CheckpointRing of arrays (the JAX package's) -> the port's."""
    return CheckpointRing(states=state_to_torch(ring.states, device),
                          prefix=array_to_torch(np.array(ring.prefix), device))


def ring_to_numpy(ring: CheckpointRing) -> dict:
    """The port's CheckpointRing -> {states: {field: numpy}, prefix} with the
    JAX dtypes."""
    return {"states": state_to_numpy(ring.states), "prefix": ring.prefix.cpu().numpy()}


def problem_to_torch(prob, device) -> tuple:
    """A convex `_Problem` of either package (numpy fields) -> the port's
    admm_pack arguments on `device` (run_req, run_count, cand_cap,
    cand_cost, feas), padded as ConvexSolver._dispatch pads them; float32,
    int32 and bool keep their types."""
    from .convex import pad_problem

    return tuple(torch.from_numpy(a).to(device) for a in pad_problem(prob))
