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
    node: id, zone, ct, cpu, mem, pods, pod_labels, hostname (bool)
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
            wk.CAPACITY_TYPE_LABEL: n.get("ct", "on-demand"),
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


ZK, CK = "topology.kubernetes.io/zone", "karpenter.sh/capacity-type"
DEFAULT_POOL = [dict(name="default")]


def _spread(n, prefix, sel=None, key=ZK, skew=1, labels=None, cpu="1", mem="1Gi", **kw):
    """n pods spreading over `key` on selector `sel` (self-matching unless
    `labels` says otherwise)."""
    sel = sel or {"app": "w"}
    return [pod(f"{prefix}{i:03d}", cpu=cpu, mem=mem,
                labels=sel if labels is None else labels, tsc=[(skew, key, sel)], **kw)
            for i in range(n)]


def _aff(n, prefix, sel, key=ZK, anti=False, labels=None, cpu="1", mem="1Gi"):
    """n pods with one (anti-)affinity term on `key` (self-matching unless
    `labels` says otherwise)."""
    return [pod(f"{prefix}{i:03d}", cpu=cpu, mem=mem, labels=sel if labels is None else labels,
                aff=[(sel, key, anti)])
            for i in range(n)]


def _zone_fuzz(seed: int) -> dict:
    """Random single-axis-per-pod mixes of zone/ct spread, zone affinity and
    ct anti locks, plus existing nodes that hold member pods (the shape of
    tests/test_mixed_axis_device.py test_mixed_axis_fuzz)."""
    rng = random.Random(3000 + seed)
    pods = []
    for i in range(rng.randrange(8, 26)):
        k, name = rng.random(), f"p{i:03d}"
        if k < 0.35:
            pods += _spread(1, name, {"app": "w"})
        elif k < 0.6:
            pods += _spread(1, name, {"tier": "ct"}, key=CK, skew=rng.choice([1, 2]))
        elif k < 0.75:
            pods += _aff(1, name, {"svc": "db"})
        elif k < 0.85:
            pods += _aff(1, name, {"lock": f"k{i % 3}"}, key=CK, anti=True)
        else:
            pods.append(pod(name, cpu=rng.choice(["500m", "1", "2"])))
    nodes = [dict(id=f"n{j}", zone=rng.choice(ZONES), ct=rng.choice(CTS),
                  pod_labels=[rng.choice([{"app": "w"}, {"tier": "ct"}])] * rng.randrange(0, 3))
             for j in range(rng.randrange(0, 5))]
    return dict(pods=pods, nodes=nodes, pools=DEFAULT_POOL)


# Zone / capacity-type topology spread and pod (anti-)affinity: fleets that
# reach the zoned branch's event paths and its three closed forms (water-fill
# mega, fixed-zone affinity bulk, balanced cycles), modelled on
# tests/test_zone_device.py and tests/test_mixed_axis_device.py.
ZONE_CASES = {
    "spread_skew1_fresh": dict(
        pods=_spread(9, "s", cpu="2", mem="4Gi") + _spread(40, "t", {"app": "v"}, cpu="500m"),
        pools=DEFAULT_POOL),
    "spread_skew2_members_on_nodes": dict(
        pods=_spread(30, "s", skew=2, cpu="250m", mem="512Mi"),
        nodes=[dict(id="na", zone="zone-1a", pod_labels=[{"app": "w"}] * 5),
               dict(id="nb", zone="zone-1b", pod_labels=[{"app": "w"}] * 2),
               dict(id="nc", zone="zone-1c")],
        pools=DEFAULT_POOL),
    "spread_waterfill_unbalanced": dict(
        pods=[pod(f"pin{i}", cpu="2", labels={"app": "w"}, sel={ZK: "zone-1a"}) for i in range(7)]
        + _spread(90, "s"),
        pools=DEFAULT_POOL),
    "spread_residue_drains": dict(
        pods=_spread(40, "a", cpu="2", mem="256Mi") + _spread(40, "b", cpu="1", mem="256Mi")
        + _spread(200, "c", cpu="100m", mem="256Mi"),
        pools=DEFAULT_POOL),
    "spread_not_self_node_targets": dict(
        pods=_spread(12, "x", labels={"app": "x"}),
        nodes=[dict(id=f"n-{z[-1]}", zone=z) for z in ZONES],
        pools=DEFAULT_POOL),
    "spread_plus_hostname_and_selector": dict(
        pods=[pod(f"h{i}", cpu="500m", labels={"app": "w"},
                  tsc=[(1, ZK, {"app": "w"}), (1, "kubernetes.io/hostname", {"app": "w"})])
              for i in range(6)]
        + [pod(f"z{i}", cpu="1", mem="2Gi", sel={ZK: "zone-1b"}) for i in range(4)],
        pools=DEFAULT_POOL),
    "spread_pool_limits": dict(
        pods=_spread(24, "s", cpu="2", mem="2Gi"),
        pools=[dict(name="capped", weight=10, limits={"cpu": "8"}), dict(name="backup", weight=1)]),
    "affinity_bootstrap_and_bulk": dict(
        pods=_aff(30, "a", {"svc": "web"}, cpu="2", mem="2Gi")
        + _aff(120, "b", {"svc": "web"}, cpu="100m", mem="64Mi"),
        pools=DEFAULT_POOL),
    "affinity_committed": dict(
        pods=[pod("seed", cpu="2", labels={"svc": "web"}, sel={ZK: "zone-1b"})]
        + _aff(60, "f", {"svc": "web"}) + _aff(90, "g", {"svc": "web"}, cpu="100m", mem="64Mi"),
        pools=DEFAULT_POOL),
    "affinity_follows_existing": dict(
        pods=_aff(4, "f", {"svc": "web"}, labels={"x": "y"}, mem="2Gi"),
        nodes=[dict(id="nb", zone="zone-1b", pod_labels=[{"svc": "web"}] * 2)],
        pools=DEFAULT_POOL),
    "anti_singletons_and_owner": dict(
        pods=_aff(4, "db", {"app": "db"}, anti=True, mem="2Gi")
        + [pod("owner", cpu="2", mem="4Gi", labels={"o": "1"}, aff=[({"app": "x"}, ZK, True)])]
        + [pod(f"x{i}", labels={"app": "x"}) for i in range(3)],
        pools=DEFAULT_POOL),
    "anti_member_wave": dict(
        pods=[pod("owner", cpu="500m", labels={"tag": "o"}, aff=[({"svc": "noisy"}, ZK, True)])]
        + [pod(f"n{i:03d}", cpu="16", mem="24Gi", labels={"svc": "noisy"}) for i in range(40)],
        pools=DEFAULT_POOL),
    "affinity_wave_multi_open": dict(
        pods=_aff(40, "w", {"svc": "web"}, cpu="24", mem="32Gi")
        + _aff(30, "v", {"svc": "web"}, labels={"svc": "web", "x": "1"}, cpu="500m"),
        pools=DEFAULT_POOL),
    "spread_with_anti_owner": dict(
        pods=[pod("owner", cpu="2", mem="4Gi", labels={"o": "1"}, aff=[({"tier": "fe"}, ZK, True)])]
        + _spread(5, "fe", {"app": "w"}, skew=2, labels={"tier": "fe", "app": "w"}, mem="2Gi"),
        pools=DEFAULT_POOL),
    "ct_spread_and_anti": dict(
        pods=_spread(24, "s", key=CK) + _aff(3, "l", {"svc": "lock"}, key=CK, anti=True),
        nodes=[dict(id="n-od", zone="zone-1a"), dict(id="n-sp", zone="zone-1b", ct="spot")],
        pools=DEFAULT_POOL),
    "mixed_zone_and_ct": dict(
        pods=_spread(6, "z", cpu="2", mem="4Gi") + _spread(4, "c", {"tier": "ct"}, key=CK, mem="2Gi")
        + _aff(3, "d", {"svc": "db"}) + _aff(3, "k", {"lock": "k"}, key=CK, anti=True),
        nodes=[dict(id="n0", zone="zone-1b", ct="spot", pod_labels=[{"tier": "ct"}])],
        pools=DEFAULT_POOL),
    **{f"mixed_fuzz_{s}": _zone_fuzz(s) for s in range(3)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_tpu_and_oracle(name):
    check(CASES[name])


@pytest.mark.parametrize("name", sorted(ZONE_CASES))
def test_zone_fleets_match_tpu_and_oracle(name):
    check(ZONE_CASES[name])


@pytest.mark.parametrize("config", ["config3", "config4"])
def test_baseline_constrained_configs(config):
    """200-pod cuts of BASELINE configs 3 (zone spread) and 4 (zone
    (anti-)affinity), built by the port's copies of the bench builders and
    by bench.py itself."""
    import bench
    import chip_smoke

    name = f"build_{config}_input"
    port = TorchSolver(device="cpu")
    got = as_data(port.solve(getattr(chip_smoke, name)(200)))
    inp = getattr(bench, name)(200)
    assert got == as_data(TPUSolver().solve(inp))
    ref = as_data(ReferenceSolver().solve(quantize_input(getattr(bench, name)(200))))
    assert _parity_view(got) == _parity_view(ref)
    assert port.stats["device_solves"] == 1 and not got["errors"]


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
    """zone_spread: a pod spread on BOTH zone and capacity type, which encode
    routes to the oracle as a fallback group (one-axis spreads now solve).
    preference: a weighted ANTI term on a custom topology key, the one
    preference kind the relax path cannot express (relax_items returns None,
    encode flags a fallback group); the other preference kinds solve
    (tests/test_torch_relax.py)."""
    pods = [pod(f"p{i}", labels={"app": "a"}) for i in range(3)]
    for p in pods:
        if kind == "zone_spread":
            p["tsc"] = [(1, ZK, {"app": "a"}), (1, CK, {"app": "a"})]
        elif kind == "custom_key":
            p["tsc"] = [(1, "example.com/rack", {"app": "a"})]
    inp = build(dict(pods=pods, pools=[dict(name="default")]), "karpenter_tpu_torch")
    if kind == "preference":
        obj = pkg("karpenter_tpu_torch").obj
        for p in inp.pods:
            p.affinity_terms = [obj.PodAffinityTerm(
                label_selector={"app": "a"}, topology_key="example.com/rack", anti=True,
                weight=10)]
        from karpenter_tpu_torch.solver import relax
        from karpenter_tpu_torch.solver.encode import encode, quantize_input

        qinp = quantize_input(inp)
        assert relax.relax_items(qinp.pods[0]) is None and relax.plan(qinp) is None
        assert encode(qinp).group_fallback.any()
    with pytest.raises(UnsupportedInput):
        TorchSolver(device="cpu").solve(inp)


@pytest.mark.parametrize("limit", ["MAX_V", "MAX_Z", "MAX_P"])
def test_zone_kernel_limits_raise(limit, monkeypatch):
    """Past the zoned scan kernel's shared rows (V-axis sigs, domain
    columns, pools) the port declines with a typed error, no fallback. The
    V rows are sized at launch, so their cap is the card's (zone_v_cap):
    the MAX_V case points it at one row."""
    from karpenter_tpu_torch.solver.cuda import ffd as tffd

    if limit == "MAX_V":
        monkeypatch.setattr(tffd, "zone_v_cap", lambda device: 1)
    else:
        monkeypatch.setattr(tffd, limit, 1)
    with pytest.raises(UnsupportedInput):
        TorchSolver(device="cpu").solve(build(ZONE_CASES["spread_skew1_fresh"], "karpenter_tpu_torch"))


def _zone_fuzz_53_cut() -> dict:
    """The smallest fleet on which the reference's zoned scan diverges from
    its own oracle (ROADMAP §C.1): _zone_fuzz(53) without pods p002, p009,
    p012, p019 and p021 (17 one-CPU pods: zone spreads on app=w, zone
    affinity on svc=db, a 5-pod capacity-type spread on tier=ct, one
    existing node holding 2 tier=ct pods)."""
    spec = _zone_fuzz(53)
    drop = {"p002", "p009", "p012", "p019", "p021"}
    # a pod's name is "p" + its draw index (+ "000" from the spread/affinity
    # helpers)
    return dict(spec, pods=[p for p in spec["pods"] if p["name"][:4] not in drop])


def test_zone_fuzz_53_cut_matches_tpu():
    """The port reproduces TPUSolver on the §C.1 fleet, decision for
    decision (the scan the port transcribes, fault included)."""
    spec = _zone_fuzz_53_cut()
    assert len(spec["pods"]) == 17 and len(spec["nodes"]) == 1
    port = TorchSolver(device="cpu")
    got = as_data(port.solve(build(spec, "karpenter_tpu_torch")))
    assert got == as_data(TPUSolver().solve(build(spec, "karpenter_tpu")))
    assert port.stats["device_solves"] == 1


@pytest.mark.xfail(strict=True, reason="ROADMAP §C.1: the reference's zoned scan diverges from "
                   "its own oracle on this fleet (ct-spread pods 3/2 against the oracle's 4/1 "
                   "across claims 0 and 1); the port copies the reference")
def test_zone_fuzz_53_cut_matches_oracle():
    spec = _zone_fuzz_53_cut()
    got = as_data(TorchSolver(device="cpu").solve(build(spec, "karpenter_tpu_torch")))
    ref = as_data(ReferenceSolver().solve(quantize_input(build(spec, "karpenter_tpu"))))
    assert _parity_view(got) == _parity_view(ref)
