"""Batch bucketing for batched solves: the port of
karpenter_tpu/parallel/sharded.py's `batch_bucket`.

The JAX module also maps `ffd_solve` over a lane axis (`batched_solve`) and
pads a batch on the device (`pad_batch`); those come with cohort fusion and
the multi-GPU slice. The mesh argument of the original is the number of
devices the batch axis splits over here.
"""

from __future__ import annotations

import math
from typing import Optional


def batch_bucket(b: int, n_devices: Optional[int] = None, mult: int = 8) -> int:
    """Bucket a candidate-batch size so dispatches see one shape per bucket,
    not one per exact row count, and the batch axis divides evenly across
    `n_devices` when given (lcm of the bucket multiple and the device
    count). Shared by simulate_subsets and the speculative-probe planner."""
    if n_devices is not None:
        n_dev = int(n_devices)
        mult = mult * n_dev // math.gcd(mult, n_dev)
    return max(mult, ((b + mult - 1) // mult) * mult)
