"""The port's batched consolidation evaluator against the JAX package's and
the sequential reference.

- On every fleet class of tests/test_batched_consolidation.py (zone
  anti-affinity, zone topology spread, multi-node prefixes, positive
  hostname affinity, capacity-type domain, mixed zone+ct axis), the port's
  `BatchedConsolidationEvaluator(TorchSolver(device="cpu"))` returns the
  same SubsetVerdicts as the JAX evaluator, and the verdicts agree with
  that file's sequential oracle (`sequential_verdict`).
- `prepare` returns None on the same inputs as the reference.
- The copied searches (`speculative_binary_search`, `binary_probe_frontier`,
  `tiered_prefix_search`) equal the originals on random verdict tables.
- A reduced config-5 universe (`build_config5_universe(400, 100)`, the
  size bench.py's host-only pipeline metrics use) gives the same prefix,
  dispatches and probed verdicts through both packages.

All outputs are booleans, integers and prices read from the same offering
table: the tolerance is exact equality.
"""

import dataclasses
import random

import pytest
import torch

from karpenter_tpu.disruption import batched as jbatched
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu_torch.disruption import batched as tbatched
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput
from tests.test_batched_consolidation import sequential_verdict
from tests.test_torch_solver import build, pod

torch.set_num_threads(1)

ZONE = "topology.kubernetes.io/zone"
CT = "karpenter.sh/capacity-type"
HOST = "kubernetes.io/hostname"


def node(nid, zone, cpu="8", mem="32Gi", labels=(), ct="on-demand", pods=110):
    return dict(id=nid, zone=zone, ct=ct, cpu=cpu, mem=mem, pods=pods,
                pod_labels=[dict(x) for x in labels])


def pool(*reqs):
    return dict(name="default", weight=0, reqs=[(k, "IN", list(v), None) for k, v in reqs])


def mkpod(name, cpu="500m", mem="512Mi", **kw):
    return pod(name, cpu=cpu, mem=mem, **kw)


def universe(nodes, pools, cand_pods, cand_node, zones=None):
    """Plain data of one consolidation universe: the base input (no pods),
    the candidates' pods and nodes."""
    spec = dict(pods=[], nodes=nodes, pools=pools)
    if zones is not None:
        spec["zones"] = zones
    return dict(spec=spec, cand_pods=cand_pods, cand_node=cand_node)


def materialize(u: dict, root: str):
    """(base SolverInput, {cid: [Pod]}, {cid: node id}) of package `root`."""
    order = [(cid, p) for cid, ps in u["cand_pods"].items() for p in ps]
    full = build(dict(u["spec"], pods=[p for _, p in order]), root)
    by_name = {p.meta.name: p for p in full.pods}
    cpods = {cid: [] for cid in u["cand_pods"]}
    for cid, p in order:
        cpods[cid].append(by_name[p["name"]])
    return dataclasses.replace(full, pods=[]), cpods, dict(u["cand_node"])


AFF_DB = ({"svc": "db"}, HOST, False)
DB = dict(labels={"svc": "db"}, aff=[AFF_DB])
LOCK = dict(labels={"svc": "lock"}, aff=[({"svc": "lock"}, ZONE, True)])
ZONE_1A = (ZONE, ["zone-1a"])


def _spread(app, key=ZONE):
    sel = {"app": app} if key == ZONE else {"tier": app}
    return dict(labels=sel, tsc=[(1, key, sel)])


FLEETS = {
    # zone anti-affinity: the re-posed pod returns to its own zone / is blocked
    "zone_anti_accept": (universe(
        [node("n0", "zone-1a", labels=[{"svc": "lock"}]), node("n1", "zone-1a")],
        [pool(ZONE_1A)], {0: [mkpod("lock", **LOCK)]}, {0: "n0"}), [[0]]),
    "zone_anti_reject": (universe(
        [node("n0", "zone-1a", labels=[{"svc": "lock"}]),
         node("n1", "zone-1a", labels=[{"svc": "lock"}])],
        [pool(ZONE_1A)], {0: [mkpod("lock", **LOCK)]}, {0: "n0"}), [[0]]),
    # zone topology spread: counts rebalance without the candidate / skew blocks
    **{f"zone_tsc_{n}": (universe(
        [node("n0", "zone-1a", labels=[{"app": "x"}] * n),
         node("nb", "zone-1b", cpu="0", labels=[{"app": "x"}]),
         node("nc", "zone-1c", cpu="0", labels=[{"app": "x"}]),
         node("nabs", "zone-1a")],
        [pool(ZONE_1A)], {0: [mkpod(f"x{i}", **_spread("x")) for i in range(n)]},
        {0: "n0"}), [[0]]) for n in (2, 4)},
    "multi_node_prefixes": (universe(
        [node("c0", "zone-1a", cpu="0", labels=[{"app": "y"}]),
         node("c1", "zone-1b", cpu="0", labels=[{"app": "y"}]),
         node("c2", "zone-1c", cpu="0", labels=[{"app": "y"}]),
         node("nabs", "zone-1a", cpu="16")],
        [pool()], {i: [mkpod(f"y{i}", **_spread("y"))] for i in range(3)},
        {0: "c0", 1: "c1", 2: "c2"}), [[0, 1], [0, 1, 2], [1, 2]]),
    # positive hostname affinity (kind 2): bootstrap, co-location, full host
    "kind2_bootstrap": (universe(
        [node("n0", "zone-1a", labels=[{"svc": "db"}])], [pool()],
        {0: [mkpod("d0", **DB)]}, {0: "n0"}), [[0]]),
    "kind2_colocate": (universe(
        [node("n0", "zone-1a", labels=[{"svc": "db"}]),
         node("n1", "zone-1b", labels=[{"svc": "db"}])], [pool()],
        {0: [mkpod("d0", **DB)]}, {0: "n0"}), [[0]]),
    "kind2_member_host_full": (universe(
        [node("n0", "zone-1a"),
         node("n1", "zone-1b", cpu="100m", mem="64Mi", pods=0, labels=[{"svc": "db"}])],
        [pool()], {0: [mkpod("d0", **DB)]}, {0: "n0"}), [[0]]),
    "kind2_multi_candidate": (universe(
        [node("n0", "zone-1a", labels=[{"svc": "db"}]),
         node("n1", "zone-1b", labels=[{"svc": "db"}]), node("n2", "zone-1c")],
        [pool()], {0: [mkpod("d0", **DB)], 1: [mkpod("d1", **DB)], 2: [mkpod("x2")]},
        {0: "n0", 1: "n1", 2: "n2"}), [[0], [1], [2], [0, 1], [0, 1, 2]]),
    # capacity-type domain: the delta keys on the node's capacity type
    **{f"ct_domain_{tag}": (universe(
        [node("n0", "zone-1a", labels=[{"tier": "ct"}]),
         node("n1", "zone-1a", ct="spot", labels=[{"tier": "ct"}] * 2)],
        [pool(*reqs)], {0: [mkpod("m0", **_spread("ct", CT))]}, {0: "n0"}), [[0]])
       for tag, reqs in (("open", ()), ("spot_only", ((CT, ["spot"]),)))},
    # mixed zone+ct axis: the removed node leaves both of its columns
    **{f"mixed_axis_{tag}": (universe(
        [node("n0", "zone-1a", labels=[{"app": "w"}, {"tier": "ct"}]),
         node("n1", "zone-1b", labels=[{"app": "w"}]),
         node("n2", "zone-1c", ct="spot", labels=[{"tier": "ct"}])],
        [pool(*reqs)], {0: [mkpod("zm", **_spread("w")), mkpod("cm", **_spread("ct", CT))]},
        {0: "n0"}), [[0]])
       for tag, reqs in (("open", ()), ("spot_only", ((CT, ["spot"]),)))},
}


def _verdict_data(v):
    return (v.ok, v.has_replacement, v.replacement_price, v.replacement_type_count)


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_evaluator_matches_jax_and_sequential(name):
    u, subsets = FLEETS[name]
    jbase, jpods, jnode = materialize(u, "karpenter_tpu")
    tbase, tpods, tnode = materialize(u, "karpenter_tpu_torch")
    jv = jbatched.BatchedConsolidationEvaluator(TPUSolver()).evaluate(jbase, jpods, jnode, subsets)
    ev = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
    prep = ev.prepare(tbase, tpods, tnode)
    assert jv is not None and prep is not None, "a fleet fell off the batched path"
    tv = ev.evaluate_prepared(prep, subsets)
    assert [_verdict_data(v) for v in tv] == [_verdict_data(v) for v in jv]
    for subset, v in zip(subsets, tv):
        seq_ok, seq_repl = sequential_verdict(jbase, jpods, jnode, subset)
        assert v.ok == seq_ok, (subset, v)
        if v.ok:
            assert v.has_replacement == seq_repl, (subset, v)
    if name.startswith("mixed_axis"):
        assert prep.enc.v_axis == "mixed"


_ODD_ZONES = tuple(f"zone-{i:02d}" for i in range(17))  # 17 zones x 2 cts > 32 bits

DECLINED = {
    # no schedulable pod (G == 0)
    "no_pods": universe([node("n0", "zone-1a")], [pool()], {0: []}, {0: "n0"}),
    # custom topology key (has_topology)
    "custom_topology_key": universe(
        [node("n0", "zone-1a")], [pool()],
        {0: [mkpod("r0", labels={"a": "r"}, tsc=[(1, "example.com/rack", {"a": "r"})])]},
        {0: "n0"}),
    # custom affinity key (has_affinity)
    "custom_affinity_key": universe(
        [node("n0", "zone-1a")], [pool()],
        {0: [mkpod("r0", labels={"a": "r"}, aff=[({"a": "r"}, "example.com/rack", True)])]},
        {0: "n0"}),
    # a pod spread on zone and capacity type at once (a fallback group)
    "zone_and_ct_spread": universe(
        [node("n0", "zone-1a")], [pool()],
        {0: [mkpod("b0", labels={"t": "b"}, tsc=[(1, ZONE, {"t": "b"}), (1, CT, {"t": "b"})])]},
        {0: "n0"}),
    # Z*C > 32: the joint offering bits do not pack (UnpackableInput)
    "zc_over_32_bits": universe(
        [node("n0", "zone-00")], [pool()], {0: [mkpod("p0")]}, {0: "n0"}, zones=_ODD_ZONES),
    # a plain universe the batched path takes (the control)
    "plain_control": universe([node("n0", "zone-1a")], [pool()], {0: [mkpod("p0")]}, {0: "n0"}),
}


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_prepare_declines_where_the_reference_does(name):
    u = DECLINED[name]
    jprep = jbatched.BatchedConsolidationEvaluator(TPUSolver()).prepare(
        *materialize(u, "karpenter_tpu"))
    tprep = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu")).prepare(
        *materialize(u, "karpenter_tpu_torch"))
    assert (jprep is None) == (tprep is None)
    assert (tprep is None) == (name != "plain_control")


def test_prepare_raises_past_the_kernel_rows():
    """Shapes past the scan kernel's shared rows raise UnsupportedInput, as
    TorchSolver does (the reference has no such limit, so no None)."""
    from karpenter_tpu_torch.solver.cuda import ffd

    u = DECLINED["plain_control"]
    saved = ffd.MAX_R
    ffd.MAX_R = 1
    try:
        with pytest.raises(UnsupportedInput):
            tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu")).prepare(
                *materialize(u, "karpenter_tpu_torch"))
    finally:
        ffd.MAX_R = saved


def _table(rng, n):
    if rng.random() < 0.5:
        cut = rng.randint(1, n + 1)
        return {k: k <= cut for k in range(1, n + 2)}
    p = rng.choice((0.2, 0.5, 0.8))
    return {k: rng.random() < p for k in range(1, n + 2)}


@pytest.mark.parametrize("seed", range(6))
def test_search_copies_match_the_originals(seed):
    rng = random.Random(seed)
    for _ in range(20):
        n = rng.randint(2, 400)
        table = _table(rng, n)
        ev = lambda ks: [table[k] for k in ks]  # noqa: E731
        acc = lambda k, v: bool(v)  # noqa: E731
        for pbm in (1, 2, 7, 64, 512):
            assert tbatched.speculative_binary_search(ev, 2, n, acc, pbm) == \
                jbatched.speculative_binary_search(ev, 2, n, acc, pbm)
        for width in (2, 8, 64):
            assert tbatched.tiered_prefix_search(ev, n, acc, width) == \
                jbatched.tiered_prefix_search(ev, n, acc, width)
        lo, hi = rng.randint(1, 50), rng.randint(50, 3000)
        for levels in (0, 1, 3, 9):
            assert tbatched.binary_probe_frontier(lo, hi, levels) == \
                jbatched.binary_probe_frontier(lo, hi, levels)


def test_reduced_config5_matches_jax():
    """build_config5_universe(400, 100) (1 600 nodes, 100 candidates) through
    both packages: same prefix k, dispatches, sequential probes, and the
    same verdict for every probed prefix."""
    import bench
    import chip_smoke

    jinp, jpods, jnode = bench.build_config5_universe(400, 100)
    tinp, tpods, tnode = chip_smoke.build_config5_universe(400, 100)
    jev = jbatched.BatchedConsolidationEvaluator(TPUSolver())
    tev = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
    jprep, tprep = jev.prepare(jinp, jpods, jnode), tev.prepare(tinp, tpods, tnode)
    assert jprep is not None and tprep is not None
    jres = bench._prefix_search(jev, jprep, 100)
    tres = chip_smoke._prefix_search(tev, tprep, 100)
    assert tres == jres
    k, dispatches, n_probed, seq = tres
    assert 2 <= k <= 100 and dispatches <= 2 and seq >= 6
    ks = sorted(random.Random(3).sample(range(2, 101), 24)) + [k, k + 1]
    subsets = [list(range(kk)) for kk in ks]
    assert [_verdict_data(v) for v in tev.evaluate_prepared(tprep, subsets)] == \
        [_verdict_data(v) for v in jev.evaluate_prepared(jprep, subsets)]
