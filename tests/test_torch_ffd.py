"""The port's plain kernels against the JAX package, fed one numpy input.

`ffd_solve` (fast branch), `compact_takes`, `compact_claim_meta` and the
delta/wide output packs of karpenter_tpu_torch.solver are held against
their counterparts in karpenter_tpu.solver, on the CPU, with the same
host_kernel_args. Every output is an integer or a bit pattern, so the
tolerance is exact equality, all 16 FFDState fields included.

The JAX side keeps to one compile bucket per entry point: default catalog
(Tp=768), Sp=Gp=16, Ep=8 (no nodes) or 32, M=64, zone_engine=False.
"""

import random
import types

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.encode import encode, quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.convert import args_to_torch, output_to_numpy
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_solver import CASES, build, pod

torch.set_num_threads(1)

M = 64


def _fleet(seed: int) -> dict:
    """A randomized fleet the device path takes whole (no fallback groups):
    up to 12 distinct pod specs (sizes, selectors, tolerations) repeated
    20-50 times, two or three weighted pools with limits, and up to 8
    existing nodes."""
    rng = random.Random(seed)
    specs = []
    for _ in range(12):
        kw = {}
        r = rng.random()
        if r < 0.2:
            kw["sel"] = {"kubernetes.io/arch": rng.choice(["amd64", "arm64"])}
        elif r < 0.35:
            kw["sel"] = {"topology.kubernetes.io/zone": rng.choice(["zone-1a", "zone-1c"])}
        elif r < 0.45:
            kw["tol"] = [("gpu", "true", "NoSchedule")]
        specs.append(dict(cpu=f"{rng.choice([100, 500, 1000, 3000])}m",
                          mem=f"{rng.choice([128, 1024, 4096])}Mi", **kw))
    pods = [pod(f"p{i:03d}", **rng.choice(specs)) for i in range(rng.randint(20, 50))]
    pools = [dict(name="a", weight=5, limits={"cpu": str(rng.choice([8, 16, 64]))}),
             dict(name="b", weight=1)]
    if seed % 2:
        pools.append(dict(name="t", weight=9, taints=[("gpu", "true", "NoSchedule")]))
    nodes = [dict(id=f"n{j}", zone=("zone-1a", "zone-1b", "zone-1c")[j % 3],
                  cpu=str(rng.choice([2, 4, 8])))
             for j in range(rng.randint(0, 8))]
    return dict(pods=pods, pools=pools, nodes=nodes)


SCAN_CASES = {
    "existing_nodes": CASES["existing_nodes"],
    "pools_weights_limits": CASES["config2_limits"],
    "taints_selectors": CASES["config2_masks"],
    "hostname_q_kinds": CASES["hostname_q_kinds"],
    "kind2_existing_member": CASES["hostname_affinity_existing_member"],
    "kind2_bootstrap_open_claim": CASES["hostname_affinity_bootstrap_open_claim"],
    **{f"fleet_{s}": _fleet(s) for s in range(4)},
}


def _host_args(spec: dict):
    enc = encode(quantize_input(build(spec, "karpenter_tpu")))
    assert not enc.group_fallback.any() and enc.V == 0
    args, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    assert (dims["Sp"], dims["Gp"], dims["Tp"]) == (16, 16, 768) and dims["Ep"] in (8, 32)
    return enc, args


def _solve_both(spec: dict):
    enc, args = _host_args(spec)
    j = jffd.ffd_solve(*args, max_claims=M, zone_engine=False)
    t = tffd.ffd_solve(*args_to_torch(args, "cpu"), max_claims=M)
    return enc, args, j, t


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_ffd_scan_matches_jax(name):
    _, _, j, t = _solve_both(SCAN_CASES[name])
    tn = output_to_numpy(t)
    for k in ("take_e", "take_c", "leftover"):
        _equal(getattr(j, k), tn[k])
    assert set(tn["state"]) == set(jffd.FFDState._fields)
    for f in jffd.FFDState._fields:
        _equal(getattr(j.state, f), tn["state"][f])
    assert int(tn["take_c"].sum() + tn["take_e"].sum()) > 0


@pytest.mark.parametrize("name", ["existing_nodes", "hostname_q_kinds", "fleet_1"])
def test_output_packs_match_jax(name):
    """The delta pack (compact_takes + word pack + compact_claim_meta) and
    the wide pack equal the JAX buffers word for word."""
    enc, args, j, t = _solve_both(SCAN_CASES[name])
    total = int(sum(len(p) for p in enc.group_pods))
    Sp, Ep = t.take_e.shape
    cap = tbackend.delta_capacity(total, Sp, Ep, M)
    cap_u = tbackend.delta_uniq_capacity(Sp, M)
    _equal(jbackend._pack_outputs_delta(j, cap, cap_u),
           tbackend._pack_outputs_delta(t, cap, cap_u).numpy())
    _equal(jbackend._pack_outputs_wide(j), tbackend._pack_outputs_wide(t).numpy())


def _random_takes(seed: int, Sp=16, E=8, Mc=64, density=0.1, big=False):
    rng = np.random.default_rng(seed)
    te = np.where(rng.random((Sp, E)) < density, rng.integers(1, 50, (Sp, E)), 0).astype(np.int32)
    tc = np.where(rng.random((Sp, Mc)) < density, rng.integers(1, 50, (Sp, Mc)), 0).astype(np.int32)
    if big:
        tc[3, 7] = 70_000
    return te, tc


@pytest.mark.parametrize("case", ["fits", "n_over_cap", "take_over_u16"])
def test_compact_takes_matches_jax(case):
    te, tc = _random_takes(7, big=case == "take_over_u16")
    cap = 32 if case == "n_over_cap" else 256
    jo = jffd.compact_takes(te, tc, cap)
    to = tffd.compact_takes(torch.from_numpy(te), torch.from_numpy(tc), cap)
    for a, b in zip(jo, to):
        _equal(a, b.numpy())
    assert int(to[0]) == (case != "fits")


@pytest.mark.parametrize("case", ["fits", "n_u_over_cap_u"])
def test_compact_claim_meta_matches_jax(case):
    rng = np.random.default_rng(11)
    Mc, T, W = 64, 300, 2
    base = rng.random((6, T)) < 0.5  # six distinct masks, repeated
    c_mask = base[rng.integers(0, 6, Mc)]
    c_zc = rng.choice(np.array([3, 7, 2**31 + 5], dtype=np.uint32), Mc)
    c_gbits = np.zeros((Mc, W), np.uint32)
    c_gbits[:, 1] = rng.choice(np.array([0, 2**31], dtype=np.uint32), Mc)
    c_pool = rng.integers(-1, 2, Mc).astype(np.int32)
    cap_u = 4 if case == "n_u_over_cap_u" else 64
    cm_words = jbackend.pack_words(c_mask, T)
    jo = jffd.compact_claim_meta(cm_words, c_zc, c_gbits, c_pool, cap_u)
    to = tffd.compact_claim_meta(
        torch.from_numpy(c_mask), torch.from_numpy(c_zc.view(np.int32)),
        torch.from_numpy(c_gbits.view(np.int32)), torch.from_numpy(c_pool), cap_u)
    for a, b in zip(jo, to[:4]):
        _equal(a, b.numpy())
    _equal(cm_words.view(np.int32), to[4][:, : cm_words.shape[1]].numpy())
    assert int(to[0]) == (case != "fits")


def test_kernel_entry_points_refuse_cpu_launch():
    """The CUDA wrappers take CUDA tensors only; a CPU tensor never reaches
    them (ffd_solve and friends route it to the plain version). The delta
    pack's takes go to the card through pack_delta (K2 and K3 in one
    launch)."""
    te, tc = _random_takes(1)
    Sp, Mc = tc.shape
    state = types.SimpleNamespace(
        c_mask=torch.zeros((Mc, 40), dtype=torch.bool), c_zc_bits=torch.zeros(Mc, dtype=torch.int32),
        c_gbits=torch.zeros((Mc, 1), dtype=torch.int32), c_pool=torch.zeros(Mc, dtype=torch.int32),
        used=torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError):
        tffd._pack_delta_cuda(torch.from_numpy(te), torch.from_numpy(tc),
                              torch.zeros(Sp, dtype=torch.int32), state, 256, 16)
    with pytest.raises(ValueError):
        tffd._mask_words_cuda(state.c_mask)
