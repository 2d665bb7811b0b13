"""Batched solves over a lane axis: the port of
karpenter_tpu/parallel/sharded.py's `batch_bucket`, `batched_solve` and
`pad_batch`.

`batched_solve` runs `ffd_solve` on every lane of a [B, ...] argument
tuple (the JAX `jax.vmap(ffd_solve)`): on the card one launch of K15
(cuda/ffd.py ffd_solve_lanes, one block per lane). `pad_batch` pads such a
tuple to a batch bucket on the device by replicating its last lane: one
launch of K16 (cuda/arena.py pad_lanes). Both serve the fused cohort
dispatch (solver/backend.py solve_cohort_async).

The mesh argument of the original is the number of devices the batch axis
splits over here; the port runs a batch on one card (the multi-GPU split
is ROADMAP B14).
"""

from __future__ import annotations

import math
from typing import Optional


def batch_bucket(b: int, n_devices: Optional[int] = None, mult: int = 8) -> int:
    """Bucket a candidate-batch size so dispatches see one shape per bucket,
    not one per exact row count, and the batch axis divides evenly across
    `n_devices` when given (lcm of the bucket multiple and the device
    count). Shared by simulate_subsets, the speculative-probe planner and
    the cohort dispatch."""
    if n_devices is not None:
        n_dev = int(n_devices)
        mult = mult * n_dev // math.gcd(mult, n_dev)
    return max(mult, ((b + mult - 1) // mult) * mult)


def batched_solve(batched_args: tuple, max_claims: int, zone_engine: bool = True):
    """ffd_solve over a leading lane axis: `batched_args` are the ARG_SPEC
    tensors, each with a leading axis B. Returns an FFDOutput whose fields
    carry the same leading axis. `zone_engine` is ffd_solve's (the cohort
    dispatch passes the members' shared `enc.V > 0`, so a fused lane runs
    the instance its solo dispatch would). A fused lane can carry V > 0:
    the cohort dispatch declines only custom-key topology and affinity, so
    members with zone or capacity-type spreads fuse through the zoned
    instance (ffd_lanes_kernel<true>)."""
    from ..solver.cuda.ffd import ffd_solve_lanes

    return ffd_solve_lanes(*batched_args, max_claims=max_claims, zone_engine=zone_engine)


def pad_batch(batched_args: tuple, batch: int) -> tuple:
    """Pad a batched args tuple to `batch` lanes by replicating the LAST
    real member's lane on the device: no host->device bytes, no ledger
    traffic. Decode discards the pad lanes, whose content only needs to be
    a valid solve, which the replicated member is. A tuple already at (or
    past) `batch` lanes passes through as the same objects."""
    if not batched_args:
        return tuple(batched_args)
    if int(batched_args[0].shape[0]) >= batch:
        return tuple(batched_args)
    from ..solver.cuda.arena import pad_lanes

    return pad_lanes(tuple(batched_args), batch)
