"""The port's zoned FFD scan (plain version) against the JAX package.

`ffd_solve_plain(..., zone_engine=True)` is held against the JAX
`ffd_solve(..., zone_engine=True)` on the same host_kernel_args, for fleets
with zone and capacity-type topology spread, pod (anti-)affinity, the mixed
zone+ct layout, existing nodes holding member pods and pool limits
(tests/test_torch_solver.py ZONE_CASES). Every output is an integer or a
bit pattern: the tolerance is exact equality, in take_e, take_c, leftover
and all 16 FFDState fields.

The JAX side keeps to few compile buckets: default catalog (Tp=768),
Sp=Gp=16, M=64, zone_engine=True; Ep is 8 (no nodes) or 32, Vp 4 or 8, and
the domain axis 3 (zones), 2 (capacity types) or 5 (both).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.encode import encode, quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver.convert import args_to_torch, output_to_numpy
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_solver import ZONE_CASES, build

torch.set_num_threads(1)

M = 64


def _host_args(spec: dict):
    enc = encode(quantize_input(build(spec, "karpenter_tpu")))
    assert not enc.group_fallback.any() and enc.V > 0
    args, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    assert (dims["Sp"], dims["Gp"], dims["Tp"]) == (16, 16, 768)
    return enc, args


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ZONE_CASES))
def test_zoned_scan_matches_jax(name):
    _, args = _host_args(ZONE_CASES[name])
    j = jffd.ffd_solve(*args, max_claims=M, zone_engine=True)
    t = tffd.ffd_solve(*args_to_torch(args, "cpu"), max_claims=M, zone_engine=True)
    tn = output_to_numpy(t)
    for k in ("take_e", "take_c", "leftover"):
        _equal(getattr(j, k), tn[k])
    for f in jffd.FFDState._fields:
        _equal(getattr(j.state, f), tn["state"][f])
    assert int(t.events) > 0  # the run went through the zoned branch
