"""TorchSolver(device="cpu") end to end against the JAX package's TPUSolver
and ReferenceSolver.

The port has its own object classes, so each input is a plain-data spec
that `build` turns into a SolverInput of either package; results compare
as plain data with the checks of tests/test_solver_parity.py:assert_parity
(placements, claim order and pool, type sets, pod uids, zone/ct domains,
errors). All outputs are integers and strings: the tolerance is exact
equality.
"""

import importlib
import random

import pytest
import torch

from karpenter_tpu.solver.backend import ReferenceSolver, TPUSolver
from karpenter_tpu.solver.encode import quantize_input
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput

torch.set_num_threads(1)

ZONES = ("zone-1a", "zone-1b", "zone-1c")
CTS = ("on-demand", "spot")


class Pkg:
    """The object-model modules of one package, plus its default catalog."""

    def __init__(self, root: str):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.wk = m("api.wellknown")
        self.obj = m("api.objects")
        self.sched = m("provisioning.scheduler")
        self.reqs = m("scheduling.requirements")
        self.res = m("utils.resources")
        cat = m("catalog.catalog")
        self.catalog = cat.generate(cat.CatalogSpec())


PKGS = {}


def pkg(root: str) -> Pkg:
    if root not in PKGS:
        PKGS[root] = Pkg(root)
    return PKGS[root]


def pod(name, cpu="1", mem="1Gi", **kw):
    return dict(name=name, cpu=cpu, mem=mem, **kw)


def build(spec: dict, root: str):
    """A plain-data spec -> the SolverInput of package `root`.

    pod: name, cpu, mem, sel {key: value}, labels, tol [(key, value, effect)],
         tsc [(max_skew, key, selector)], aff [(selector, key, anti)],
         extra {resource: quantity}, gated
    node: id, zone, cpu, mem, pods, pod_labels, hostname (bool)
    pool: name, weight, reqs [(key, op, values, min_values)], taints
          [(key, value, effect)], limits {resource: quantity}, types [names]
    """
    P = pkg(root)
    wk, obj, sched, rq, res = P.wk, P.obj, P.sched, P.reqs, P.res
    pods = []
    for p in spec["pods"]:
        requests = {"cpu": p["cpu"], "memory": p["mem"], **p.get("extra", {})}
        pods.append(obj.Pod(
            meta=obj.ObjectMeta(name=p["name"], uid=p["name"], labels=dict(p.get("labels", {}))),
            requests=res.Resources.parse(requests),
            node_selector=dict(p.get("sel", {})),
            tolerations=[obj.Toleration(key=k, value=v, effect=e) for k, v, e in p.get("tol", [])],
            topology_spread=[
                obj.TopologySpreadConstraint(max_skew=s, topology_key=k, label_selector=dict(sel))
                for s, k, sel in p.get("tsc", [])
            ],
            affinity_terms=[
                obj.PodAffinityTerm(label_selector=dict(sel), topology_key=k, anti=anti)
                for sel, k, anti in p.get("aff", [])
            ],
            scheduling_gated=p.get("gated", False),
        ))
    nodes = []
    for n in spec.get("nodes", []):
        labels = {
            wk.ZONE_LABEL: n.get("zone", "zone-1a"),
            wk.CAPACITY_TYPE_LABEL: "on-demand",
            wk.ARCH_LABEL: "amd64",
            wk.OS_LABEL: "linux",
        }
        if n.get("hostname", True):
            labels[wk.HOSTNAME_LABEL] = n["id"]
        free = res.Resources.parse({"cpu": n.get("cpu", "8"), "memory": n.get("mem", "32Gi")})
        free["pods"] = n.get("pods", 110)
        nodes.append(sched.ExistingNode(
            id=n["id"], labels=labels, taints=[], free=free,
            pod_labels=[dict(x) for x in n.get("pod_labels", [])],
        ))
    pools = []
    for pl in spec["pools"]:
        r = rq.Requirements.of(rq.Requirement.create(wk.NODEPOOL_LABEL, rq.IN, [pl["name"]]))
        for key, op, values, mv in pl.get("reqs", []):
            r.add(rq.Requirement.create(key, getattr(rq, op), list(values), min_values=mv))
        names = pl.get("types")
        types = P.catalog if names is None else [it for it in P.catalog if it.name in names]
        pools.append(sched.NodePoolSpec(
            name=pl["name"], weight=pl.get("weight", 0), requirements=r,
            taints=[obj.Taint(key=k, value=v, effect=e) for k, v, e in pl.get("taints", [])],
            instance_types=types,
            limits=res.Resources.parse(pl.get("limits", {})),
        ))
    return sched.SolverInput(pods=pods, nodes=nodes, nodepools=pools, zones=tuple(spec.get("zones", ZONES)))


def as_data(res) -> dict:
    """A SolverResult of either package as plain comparable data."""
    claims = []
    for c in res.claims:
        doms = []
        for key, universe in (("topology.kubernetes.io/zone", ZONES),
                              ("karpenter.sh/capacity-type", CTS)):
            r = c.requirements.get(key)
            vals = set(r.values_list()) if r is not None and not r.complement else None
            doms.append(sorted(vals or universe))
        claims.append(dict(pool=c.nodepool, types=sorted(c.instance_type_names),
                           pods=list(c.pod_uids), domains=doms,
                           requests=sorted(c.requests.items())))
    return dict(placements=dict(res.placements), claims=claims, errors=sorted(res.errors))


def _parity_view(d: dict) -> dict:
    """The fields assert_parity compares against the oracle."""
    return dict(placements=d["placements"], errors=d["errors"],
                claims=[{k: c[k] for k in ("pool", "types", "pods", "domains")} for c in d["claims"]])


def check(spec: dict, oracle: bool = True, **solver_kw):
    """Port vs TPUSolver (every field) and vs the oracle (assert_parity's
    fields). Returns (port solver, port result data)."""
    port = TorchSolver(device="cpu", **solver_kw)
    got = as_data(port.solve(build(spec, "karpenter_tpu_torch")))
    tpu = as_data(TPUSolver(**solver_kw).solve(build(spec, "karpenter_tpu")))
    assert got == tpu
    if oracle:
        ref = as_data(ReferenceSolver().solve(quantize_input(build(spec, "karpenter_tpu"))))
        assert _parity_view(got) == _parity_view(ref)
    assert port.stats["device_solves"] == 1
    return port, got


def _fuzz_spec(seed: int) -> dict:
    rng = random.Random(seed)
    pods = []
    for i in range(rng.randint(10, 60)):
        kw = {}
        r = rng.random()
        if r < 0.2:
            kw["sel"] = {"kubernetes.io/arch": rng.choice(["amd64", "arm64"])}
        elif r < 0.3:
            kw["sel"] = {"topology.kubernetes.io/zone": rng.choice(ZONES)}
        elif r < 0.35:
            kw["sel"] = {"karpenter.sh/capacity-type": rng.choice(CTS)}
        pods.append(pod(f"p{i:03d}", cpu=f"{rng.choice([50, 100, 500, 1000, 2000, 7000])}m",
                        mem=f"{rng.choice([64, 300, 1024, 3000, 9000])}Mi", **kw))
    pools = [dict(name="a", weight=5), dict(name="b", weight=1)]
    if seed % 2:
        pools[0]["reqs"] = [("karpenter.sh/capacity-type", "IN", ["spot"], None)]
    return dict(pods=pods, pools=pools)


NO_SCHEDULE = "NoSchedule"
GPU_TAINT = ("gpu", "true", NO_SCHEDULE)

CASES = {
    # config 1: cpu/mem-only pods, one pool, full catalog
    "config1_heterogeneous": dict(
        pods=[pod(f"p{i:03d}", cpu=f"{random.Random(i).choice([100, 250, 500, 1000, 2000, 4000])}m",
                  mem=f"{random.Random(-i).choice([128, 256, 512, 1024, 4096])}Mi") for i in range(60)],
        pools=[dict(name="default")]),
    "config1_unschedulable": dict(
        pods=[pod("big", cpu="999"), pod("ok")], pools=[dict(name="default")]),
    # config 2: selectors, taints, weights, limits over mixed pools
    "config2_masks": dict(
        pods=[pod(f"a{i}", sel={"kubernetes.io/arch": "arm64"}) for i in range(5)]
        + [pod(f"z{i}", sel={"topology.kubernetes.io/zone": ZONES[i % 3]}) for i in range(6)]
        + [pod(f"g{i}", tol=[GPU_TAINT]) for i in range(3)]
        + [pod("odonly", sel={"karpenter.sh/capacity-type": "on-demand"})]
        + [pod(f"x{i}", cpu="4", mem="8Gi", extra={"nvidia.com/gpu": "1"}) for i in range(2)],
        pools=[dict(name="gpu", weight=50, taints=[GPU_TAINT]),
               dict(name="spot", weight=10, reqs=[("karpenter.sh/capacity-type", "IN", ["spot"], None)]),
               dict(name="od", weight=1, reqs=[("karpenter.sh/capacity-type", "IN", ["on-demand"], None)])]),
    "config2_limits": dict(
        pods=[pod(f"p{i:02d}", cpu="2", mem="2Gi") for i in range(12)],
        pools=[dict(name="capped", weight=10, limits={"cpu": "8"}), dict(name="backup", weight=1)]),
    "existing_nodes": dict(
        pods=[pod(f"p{i:02d}", cpu="3", mem="4Gi") for i in range(8)]
        + [pod(f"s{i}", sel={"topology.kubernetes.io/zone": "zone-1b"}) for i in range(3)],
        nodes=[dict(id="n1"), dict(id="n2", zone="zone-1b")],
        pools=[dict(name="default")]),
    # hostname (Q axis) constraints: TSC (kind 0), anti (kind 1), positive
    # affinity (kind 2) with and without the bootstrap
    "hostname_q_kinds": dict(
        pods=[pod(f"w{i}", cpu="200m", mem="256Mi", labels={"app": "web"},
                  tsc=[(1, "kubernetes.io/hostname", {"app": "web"})]) for i in range(5)]
        + [pod(f"d{i}", cpu="250m", mem="512Mi", labels={"app": "db"},
               aff=[({"app": "db"}, "kubernetes.io/hostname", True)]) for i in range(4)]
        + [pod(f"c{i}", cpu="100m", mem="128Mi", labels={"app": "cache"},
               aff=[({"app": "cache"}, "kubernetes.io/hostname", False)]) for i in range(6)]
        + [pod(f"f{i}", cpu="100m", mem="128Mi") for i in range(4)],
        nodes=[dict(id="n1", pod_labels=[{"app": "web"}])],
        pools=[dict(name="default")]),
    "hostname_affinity_existing_member": dict(
        pods=[pod(f"c{i}", cpu="100m", mem="128Mi", labels={"app": "cache"},
                  aff=[({"app": "cache"}, "kubernetes.io/hostname", False)]) for i in range(5)],
        nodes=[dict(id="n1"), dict(id="n2", pod_labels=[{"app": "cache"}])],
        pools=[dict(name="default")]),
    # kind-2 bootstrap whose first target is an OPEN claim (opened by an
    # earlier run): the group follows it there and opens no fresh claim
    "hostname_affinity_bootstrap_open_claim": dict(
        pods=[pod("big", cpu="1", mem="1Gi")]
        + [pod(f"c{i}", cpu="400m", mem="256Mi", labels={"app": "cache"},
               aff=[({"app": "cache"}, "kubernetes.io/hostname", False)]) for i in range(5)],
        pools=[dict(name="default",
                    reqs=[("node.kubernetes.io/instance-type", "IN", ["m5.large"], None)])]),
    **{f"fuzz_{s}": _fuzz_spec(s) for s in range(3)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_tpu_and_oracle(name):
    check(CASES[name])


def _one_per_claim(n: int) -> dict:
    """n pods that each need a claim of their own (100 cpu each)."""
    return dict(pods=[pod(f"b{i:04d}", cpu="100", mem="1Gi") for i in range(n)],
                pools=[dict(name="default")])


def test_claim_bucket_doubles():
    """600 claims saturate the M0=512 bucket; both backends double to 1024.
    Held against TPUSolver only: the sequential oracle's first-fit over
    hundreds of full claims is too slow for the tier-1 budget, and
    tests/test_solver_parity.py holds TPUSolver to it."""
    port, got = check(_one_per_claim(600), oracle=False)
    assert port.stats["claim_doublings"] == 1
    assert len(got["claims"]) == 600


def test_claim_overflow_raises():
    """Past max_claims the port declines; TPUSolver replays on its fallback."""
    spec = _one_per_claim(70)
    with pytest.raises(UnsupportedInput):
        TorchSolver(device="cpu", max_claims=64).solve(build(spec, "karpenter_tpu_torch"))
    tpu = TPUSolver(max_claims=64)
    tpu.solve(build(spec, "karpenter_tpu"))
    assert tpu.stats["fallback_solves"] == 1


def test_wide_refetch(monkeypatch):
    """A delta capacity too small for the solve's entries forces the full-
    width re-fetch in both packages; decisions stay equal."""
    from karpenter_tpu.solver import backend as jbackend

    monkeypatch.setattr(jbackend, "delta_capacity", lambda *a: 4)
    monkeypatch.setattr(tbackend, "delta_capacity", lambda *a: 4)
    port, _ = check(CASES["existing_nodes"])
    assert port.stats["wide_refetches"] == 1


def test_no_schedulable_pods():
    """G == 0: the port returns what TPUSolver returns."""
    spec = dict(pods=[pod("gated", gated=True)], pools=[dict(name="default")])
    got = as_data(TorchSolver(device="cpu").solve(build(spec, "karpenter_tpu_torch")))
    assert got == as_data(TPUSolver().solve(build(spec, "karpenter_tpu")))
    assert got == dict(placements={}, claims=[], errors=[])


@pytest.mark.parametrize("kind", ["zone_spread", "preference", "custom_key"])
def test_out_of_slice_inputs_raise(kind):
    pods = [pod(f"p{i}", labels={"app": "a"}) for i in range(3)]
    for p in pods:
        if kind == "zone_spread":
            p["tsc"] = [(1, "topology.kubernetes.io/zone", {"app": "a"})]
        elif kind == "custom_key":
            p["tsc"] = [(1, "example.com/rack", {"app": "a"})]
    inp = build(dict(pods=pods, pools=[dict(name="default")]), "karpenter_tpu_torch")
    if kind == "preference":
        obj = pkg("karpenter_tpu_torch").obj
        for p in inp.pods:
            p.affinity_terms = [obj.PodAffinityTerm(
                label_selector={"app": "a"}, topology_key="kubernetes.io/hostname", weight=10)]
    with pytest.raises(UnsupportedInput):
        TorchSolver(device="cpu").solve(inp)
