"""The port's batched consolidation kernels (plain versions) against the
JAX package.

`consolidate.batched_ffd` (K4's plain version) is held against the JAX
`_batched_ffd` on the same shared host_kernel_args and subset rows, and the
port's `simulate_subsets` (host row construction + scan) against the JAX
`simulate_subsets` (which runs `_sharded_ffd` on the tests' 8-device CPU
mesh; its batch bucket is lcm(8, 8) = 8, the port's is 8). `pack_verdicts`
(K5's plain version) and `fetch_verdicts` are held against the JAX ones on
the same scan outputs. Every output is an integer or a bit pattern: the
tolerance is exact equality, on leftover and all 16 FFDState fields, for
every row, padding rows included.

Fleets are seeded: consolidation universes whose candidates are existing
nodes with their pods re-posed, with subsets that include the empty
subset, a candidate with a node but no pods, rows that saturate the claim
slots (max_claims=2 with pods that need more claims), the fast instance
(no V-axis sigs) and the zoned one (zone, capacity-type and mixed spread,
zone (anti-)affinity), and hostname (Q-axis) sigs whose node rows the scan
zeroes for removed nodes.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.encode import encode, quantize_input
from karpenter_tpu.solver.tpu import consolidate as jcons
from karpenter_tpu_torch.solver.convert import args_to_torch
from karpenter_tpu_torch.solver.cuda import consolidate as tcons
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_solver import build, pod

torch.set_num_threads(1)

ZONE = "topology.kubernetes.io/zone"
CT = "karpenter.sh/capacity-type"
HOST = "kubernetes.io/hostname"


def fleet(seed: int, kind: str) -> dict:
    """A consolidation universe as plain data: `spec` (build()'s input with
    every candidate's pods pending), `cand` {pod name: candidate id},
    `cand_node` {candidate id: node id}. Candidate c owns node n{c}; the
    last candidate node holds no pods; one extra node is not a candidate.

    kind: "fast" (sizes and selectors), "hostname" (Q-axis spread,
    anti-affinity, positive affinity, member pods on nodes), "zone" (zone
    spread, zone affinity and anti-affinity), "mixed" (zone and
    capacity-type spread), "saturate" (big pods that each need a claim of
    their own)."""
    rng = random.Random(seed * 31 + len(kind))
    n_cand = rng.randint(3, 5)
    zones = ("zone-1a", "zone-1b", "zone-1c")
    pods, cand = [], {}

    def add(c, **kw):
        name = f"c{c}-{len(pods):02d}"
        pods.append(pod(name, **kw))
        cand[name] = c

    for c in range(n_cand - 1):
        for _ in range(rng.randint(1, 4)):
            if kind == "saturate":  # one claim per pod: hostname anti-affinity
                add(c, cpu=rng.choice(["6", "12"]), mem="8Gi", labels={"sat": "x"},
                    aff=[({"sat": "x"}, HOST, True)])
            elif kind == "hostname":
                app = rng.choice(["web", "db", "cache"])
                if app == "web":
                    add(c, cpu="250m", mem="256Mi", labels={"app": "web"},
                        tsc=[(1, HOST, {"app": "web"})])
                elif app == "db":
                    add(c, cpu="500m", mem="512Mi", labels={"app": "db"},
                        aff=[({"app": "db"}, HOST, True)])
                else:
                    add(c, cpu="300m", mem="256Mi", labels={"app": "cache"},
                        aff=[({"app": "cache"}, HOST, False)])
            elif kind == "zone":
                r = rng.random()
                if r < 0.4:
                    add(c, cpu="500m", mem="1Gi", labels={"app": "w"},
                        tsc=[(rng.choice([1, 2]), ZONE, {"app": "w"})])
                elif r < 0.6:
                    add(c, cpu="250m", mem="512Mi", labels={"svc": "db"},
                        aff=[({"svc": "db"}, ZONE, False)])
                elif r < 0.75:
                    add(c, cpu="1", mem="1Gi", labels={"lock": f"l{c}"},
                        aff=[({"lock": f"l{c}"}, ZONE, True)])
                else:
                    add(c, cpu="1", mem="2Gi")
            elif kind == "mixed":
                if rng.random() < 0.5:
                    add(c, cpu="500m", mem="1Gi", labels={"app": "w"},
                        tsc=[(1, ZONE, {"app": "w"})])
                else:
                    add(c, cpu="500m", mem="1Gi", labels={"tier": "ct"},
                        tsc=[(1, CT, {"tier": "ct"})])
            else:
                kw = {}
                if rng.random() < 0.25:
                    kw["sel"] = {"kubernetes.io/arch": "amd64"}
                add(c, cpu=f"{rng.choice([250, 500, 1000, 2000])}m",
                    mem=f"{rng.choice([256, 1024, 2048])}Mi", **kw)
    nodes = []
    for j in range(n_cand + 1):
        labels = []
        if kind == "hostname":
            labels = [{"app": rng.choice(["web", "db", "cache", "x"])}] * rng.randint(0, 2)
        elif kind in ("zone", "mixed"):
            labels = [{"app": "w"}] * rng.randint(0, 2) + [{"svc": "db"}] * rng.randint(0, 1)
            if kind == "mixed":
                labels += [{"tier": "ct"}] * rng.randint(0, 2)
        nodes.append(dict(id=f"n{j}", zone=zones[rng.randint(0, 2)],
                          ct=rng.choice(["on-demand", "spot"]) if kind == "mixed" else "on-demand",
                          cpu=str(rng.choice([1, 2, 4])), mem="8Gi", pod_labels=labels))
    pools = [dict(name="limited", weight=5, limits={"cpu": str(rng.choice([8, 16]))}),
             dict(name="any", weight=1)]
    return dict(spec=dict(pods=pods, nodes=nodes, pools=pools),
                cand=cand, cand_node={c: f"n{c}" for c in range(n_cand)})


def subsets_for(n_cand: int, seed: int):
    """The empty subset, each single candidate (the last has no pods), a
    pair, every candidate, and three random subsets: 9-11 rows, so the
    batch bucket of 8 always adds padding rows."""
    rng = random.Random(seed)
    subs = [[], *[[c] for c in range(n_cand)], [0, 1], list(range(n_cand))]
    for _ in range(3):
        subs.append(sorted(rng.sample(range(n_cand), rng.randint(1, n_cand))))
    return subs


def universe_args(f: dict):
    """(enc, host_args, pod_cand, pod_run, node_idx, v_delta) of a fleet,
    from the JAX package's encode (the port's is pinned to it by
    tests/test_torch_isolation.py), built as the evaluators' prepare()."""
    enc = encode(quantize_input(build(f["spec"], "karpenter_tpu")))
    assert not enc.group_fallback.any() and not enc.has_topology and not enc.has_affinity
    args, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    pod_cand = np.fromiter((f["cand"][u] for u in enc.sorted_uids), np.int64,
                           len(enc.sorted_uids))
    pod_run = np.repeat(np.arange(len(enc.run_count), dtype=np.int64), enc.run_count)
    id_to_e = {nid: e for e, nid in enumerate(enc.node_ids)}
    node_idx = {c: id_to_e[n] for c, n in f["cand_node"].items()}
    v_delta = None
    if enc.V:
        v_delta = {}
        n_dom = len(enc.v_domains) if enc.v_domains is not None else len(enc.zones)
        for c, e in node_idx.items():
            d = np.zeros((enc.V, n_dom), dtype=np.int32)
            for z in (int(enc.v_node_domain[e]),
                      int(enc.node_dom2[e]) if enc.node_dom2 is not None else -1):
                if z >= 0:
                    d[:, z] = enc.node_v_member[e]
            if d.any():
                v_delta[c] = d
    return enc, args, pod_cand, pod_run, node_idx, v_delta


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def assert_outputs_equal(j, t):
    assert tuple(t.take_e.shape)[1] == 0 and tuple(t.take_c.shape)[1] == 0
    _equal(j.leftover, t.leftover.numpy(), "leftover")
    for f in j.state._fields:
        _equal(getattr(j.state, f), getattr(t.state, f).numpy(), f)


# (kind, seed, max_claims): M=2 saturates the rows that need more claims
SCAN_CASES = [
    ("fast", 0, 16), ("fast", 1, 2), ("hostname", 0, 16), ("hostname", 1, 16),
    ("zone", 0, 16), ("zone", 1, 2), ("zone", 2, 16), ("mixed", 0, 16), ("mixed", 1, 2),
    ("saturate", 0, 2), ("saturate", 1, 16),
]


@pytest.mark.parametrize("kind,seed,M", SCAN_CASES, ids=lambda v: str(v))
def test_batched_ffd_matches_jax(kind, seed, M):
    f = fleet(seed, kind)
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    zone = enc.V > 0
    assert zone == (kind in ("zone", "mixed"))
    subs = subsets_for(len(f["cand_node"]), seed)
    rows = tcons.subset_rows(args, pod_cand, pod_run, subs, node_idx, v_delta,
                             args[tcons._V_COUNT0])
    assert rows[0].shape[0] > len(subs)  # padding rows are compared too
    j = jcons._batched_ffd(tuple(args), *rows, M, False, zone)
    t = tcons.batched_ffd(args_to_torch(args, "cpu"), *tcons.upload_rows(rows, "cpu"), M, zone)
    assert_outputs_equal(j, t)
    used = np.asarray(j.state.used)
    if kind == "saturate" and M == 2:
        assert (used == M).any(), "no row saturated the claim slots"
    if zone:
        assert int(t.events.sum()) > 0


@pytest.mark.parametrize("kind,seed", [("fast", 2), ("hostname", 2), ("zone", 3), ("mixed", 2)])
def test_simulate_subsets_matches_jax(kind, seed):
    """The host row construction too: the port's simulate_subsets against
    the JAX one (sharded over the 8 virtual CPU devices)."""
    f = fleet(seed, kind)
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    zone = enc.V > 0
    subs = subsets_for(len(f["cand_node"]), seed + 7)
    j = jcons.simulate_subsets(args, pod_cand, pod_run, subs, node_idx, 16,
                               candidate_v_delta=v_delta, verdict_only=True,
                               zone_engine=zone, v_count0_host=args[jcons._V_COUNT0])
    t = tcons.simulate_subsets(args_to_torch(args, "cpu"), pod_cand, pod_run, subs, node_idx,
                               16, candidate_v_delta=v_delta, zone_engine=zone,
                               v_count0_host=args[tcons._V_COUNT0])
    assert_outputs_equal(j, t)


@pytest.mark.parametrize("kind,seed,M", [("zone", 0, 16), ("saturate", 0, 2), ("mixed", 1, 2)])
def test_pack_and_fetch_verdicts_match_jax(kind, seed, M):
    f = fleet(seed, kind)
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    zone = enc.V > 0
    subs = subsets_for(len(f["cand_node"]), seed)
    rows = tcons.subset_rows(args, pod_cand, pod_run, subs, node_idx, v_delta,
                             args[tcons._V_COUNT0])
    j = jcons._batched_ffd(tuple(args), *rows, M, False, zone)
    t = tcons.batched_ffd(args_to_torch(args, "cpu"), *tcons.upload_rows(rows, "cpu"), M, zone)
    _equal(jcons._pack_verdicts(j), tcons.pack_verdicts(t).numpy(), "pack_verdicts")
    for n_rows in (len(subs), rows[0].shape[0]):
        for name, a, b in zip(("leftover", "used", "zc", "c_mask"),
                              jcons.fetch_verdicts(j, enc.T, n_rows),
                              tcons.fetch_verdicts(t, enc.T, n_rows)):
            _equal(a, b, name)


def test_pack_verdicts_wraps_the_leftover_total():
    """The leftover total is an int32 sum that wraps, as JAX's with x64 off."""
    f = fleet(0, "fast")
    enc, args, pod_cand, pod_run, node_idx, v_delta = universe_args(f)
    rows = tcons.subset_rows(args, pod_cand, pod_run, [[0]], node_idx, None,
                             args[tcons._V_COUNT0])
    t = tcons.batched_ffd(args_to_torch(args, "cpu"), *tcons.upload_rows(rows, "cpu"), 16, False)
    big = torch.full_like(t.leftover, 2**30)
    t = t._replace(leftover=big)
    flat = tcons.pack_verdicts(t).reshape(t.leftover.shape[0], -1)
    Sp = t.leftover.shape[1]
    assert int(flat[0, 0]) == (Sp * 2**30 + 2**31) % 2**32 - 2**31
    assert int(flat[0, 0]) != Sp * 2**30  # the total did wrap


def test_replacement_min_price_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        T, Z, C = 7, 3, 2
        avail = rng.random((T, Z, C)) < 0.5
        price = rng.random((T, Z, C)).astype(np.float32)
        m, z, c = rng.random(T) < 0.5, rng.random(Z) < 0.6, rng.random(C) < 0.7
        assert tcons.replacement_min_price(m, z, c, avail, price) == jcons.replacement_min_price(
            m, z, c, avail, price)


def test_arg_indices_pinned():
    for n in ("_RUN_COUNT", "_NODE_COMPAT", "_V_COUNT0", "_NODE_QM", "_NODE_QO"):
        assert getattr(tcons, n) == getattr(jcons, n), n
