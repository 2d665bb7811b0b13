"""The dense output pack (pack_outputs, K9) and device_decode=False against
the JAX package.

- pack_outputs_plain equals the JAX `_pack_outputs` (backend.py:511) word
  for word on seeded outputs: odd Sp·Ep and Sp·M (the uint16 pairs pad),
  Tp not a multiple of 32 (the mask words' tail), a take past 65535 (the
  overflow flag), uint32 words with the top bit set;
- TorchSolver(device="cpu", device_decode=False) decides as
  TPUSolver(device_decode=False), with the same fetch bytes, and through a
  forced wide re-fetch;
- the pack-selection rule: a dispatch whose node + claim axis is past the
  uint16 delta coding takes the dense pack in both packages (no decline),
  and its unpack equals the JAX one.

Every value is an integer or a bit pattern: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.convert import state_to_torch
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_solver import CASES, ZONE_CASES, as_data, build

torch.set_num_threads(1)


def _outputs(seed: int, Sp: int, Ep: int, M: int, T: int, big: bool):
    """A seeded JAX FFDOutput of the given shapes (the state fields the pack
    reads random, the others zero) and the port's copy of it."""
    rng = np.random.default_rng(seed)
    W, R, P, Q, V, Z = 2, 3, 4, 1, 1, 3
    take_e = rng.integers(0, 300, (Sp, Ep)).astype(np.int32)
    take_c = np.where(rng.random((Sp, M)) < 0.3, rng.integers(0, 70, (Sp, M)), 0).astype(np.int32)
    if big:
        take_c[Sp - 1, M - 1] = 70_000
    st = dict(
        e_cum=np.zeros((Ep, R), np.int32),
        c_cum=rng.integers(-2**31, 2**31, (M, R), dtype=np.int64).astype(np.int32),
        c_mask=rng.random((M, T)) < 0.5,
        c_zc_bits=rng.integers(0, 2**32, (M,), dtype=np.uint64).astype(np.uint32),
        c_gbits=rng.integers(0, 2**32, (M, W), dtype=np.uint64).astype(np.uint32),
        c_pool=rng.integers(-1, P, (M,)).astype(np.int32),
        used=np.array(int(rng.integers(0, M)), np.int32),
        p_usage=np.zeros((P, R), np.int32), e_cm=np.zeros((Ep, Q), np.int32),
        e_co=np.zeros((Ep, Q), np.int32), c_cm=np.zeros((M, Q), np.int32),
        c_co=np.zeros((M, Q), np.int32), v_count=np.zeros((V, Z), np.int32),
        v_owner_z=np.zeros((V, Z), bool), c_vm=np.zeros((M, V), np.int32),
        c_vo=np.zeros((M, V), bool),
    )
    leftover = rng.integers(0, 5, (Sp,)).astype(np.int32)
    jout = jffd.FFDOutput(take_e=take_e, take_c=take_c, leftover=leftover,
                          state=jffd.FFDState(**st))
    tst = state_to_torch(st, "cpu")
    tout = tffd.FFDOutput(take_e=torch.from_numpy(take_e), take_c=torch.from_numpy(take_c),
                          leftover=torch.from_numpy(leftover), state=tst,
                          events=torch.zeros((), dtype=torch.int32))
    return jout, tout


SHAPES = [  # (Sp, Ep, M, T, big)
    (3, 5, 7, 100, False),   # odd Sp*Ep and Sp*M, T % 32 != 0
    (16, 8, 64, 128, False),
    (17, 9, 65, 33, True),   # a take past uint16: the flag
    (1, 1, 1, 1, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}" for s in SHAPES])
def test_pack_outputs_plain_matches_jax(shape):
    jout, tout = _outputs(sum(shape[:4]), *shape)
    want = np.asarray(jbackend._pack_outputs(jout))
    got = tffd.pack_outputs(tout.take_e, tout.take_c, tout.leftover, tout.state)
    assert got.dtype == torch.int32 and got.dim() == 1
    Sp, Ep, M, T, big = shape
    assert got.numel() == tffd.pack_words(Sp, Ep, M, T, 2, 3)
    assert np.array_equal(got.numpy(), want)
    assert int(got[0]) == int(big)


def _solve_pair(spec, **kw):
    port = TorchSolver(device="cpu", **kw)
    tpu = TPUSolver(**kw)
    got = as_data(port.solve(build(spec, "karpenter_tpu_torch")))
    assert got == as_data(tpu.solve(build(spec, "karpenter_tpu")))
    for k in ("d2h_bytes", "d2h_msgs", "h2d_bytes", "h2d_msgs"):
        assert port.ledger.solve[k] == tpu.ledger.solve[k], (k, port.ledger.solve,
                                                              tpu.ledger.solve)
    return port, tpu


@pytest.mark.parametrize("name", ["existing_nodes", "hostname_q_kinds", "mixed_zone_and_ct"])
def test_device_decode_off_matches_tpu_solver(name):
    spec = {**CASES, **ZONE_CASES}[name]
    port, _ = _solve_pair(spec, device_decode=False)
    assert not port.device_decode and port.stats["device_solves"] == 1
    on = TorchSolver(device="cpu")
    assert as_data(on.solve(build(spec, "karpenter_tpu_torch"))) == as_data(
        port.solve(build(spec, "karpenter_tpu_torch")))


def test_device_decode_off_wide_refetch(monkeypatch):
    """A take past uint16 in the dense pack re-fetches wide in both
    packages (the flag, forced here by a pack whose first word is set)."""
    real_t, real_j = tbackend._pack_outputs, jbackend._pack_outputs

    def flagged_t(out):
        flat = real_t(out).clone()
        flat[0] = 1
        return flat

    monkeypatch.setattr(tbackend, "_pack_outputs", flagged_t)
    monkeypatch.setattr(jbackend, "_pack_outputs", lambda out: real_j(out).at[0].set(1))
    port, tpu = _solve_pair(CASES["existing_nodes"], device_decode=False)
    assert port.stats["wide_refetches"] == tpu.stats["wide_refetches"] == 1


def test_past_uint16_coding_takes_the_dense_pack():
    """Ep + Mb > 65535 (here Mb = 65536 claim slots at Sp = 16): the pack
    selection takes the dense pack instead of declining, in both packages,
    and the unpacked fields equal the JAX ones."""
    jout, tout = _outputs(5, 16, 8, 65536, 40, False)
    port = TorchSolver(device="cpu")
    flat_dev, unpack = port._pack_dispatch(tout, total_pods=100)
    got = unpack(port._fetch(flat_dev))
    tpu = TPUSolver()
    jflat, junpack = tpu._pack_dispatch(jout, total_pods=100)
    want = junpack(np.asarray(jflat))
    assert "entries" not in got and set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert np.array_equal(got["take_c"], jout.take_c)
    assert port.ledger.total["d2h_bytes"] == np.asarray(jflat).nbytes
