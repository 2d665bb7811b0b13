"""Respect-mode preferences through the port against the JAX package.

Two levels, both exact (every output is an integer, a bit pattern or a
string):

- kernel: `ffd_solve_ladder_plain` (the plain version of the ladder scan
  kernel) against the JAX `ffd_solve_ladder` on the same host_kernel_args
  and run_ladder, captured from a TPUSolver solve, for both values of
  `zone_engine`: take_e, take_c, leftover and all 16 FFDState fields;
- solver: `TorchSolver(device="cpu")` through the relax ladder and through
  the host relax loop against `TPUSolver` (same `relax_ladder`) and the
  `ReferenceSolver`, with the decision checks of assert_parity
  (tests/test_solver_parity.py) and the relax stats.

The fleets are those of tests/test_decode_ladder.py::TestLadderParity, of
tests/test_relax_device.py's weighted-anti tests (admission-only kind-3
sigs on the zone, capacity-type and hostname keys), test_relax_fuzz and
test_weighted_anti_fuzz (captured by running those tests' own builders
with their parity check swapped for a capture), a run that mixes ladders
(the host loop), a weighted hostname affinity, and a 2 000-pod cut of
BASELINE config 3 with soft (ScheduleAnyway) spreads. Where TPUSolver
falls back to its oracle, the port must raise UnsupportedInput. JAX
inputs cross into the port's object model through `to_port`.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import tests.test_decode_ladder as tdl
import tests.test_relax_device as trd
from karpenter_tpu.api import wellknown as wk
from karpenter_tpu.api.objects import PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver.backend import ReferenceSolver, TPUSolver
from karpenter_tpu.solver.encode import quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput
from karpenter_tpu_torch.solver.convert import args_to_torch, array_to_torch, output_to_numpy
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_solver import _parity_view, as_data
from tests.test_zone_device import ZONES, mkpod, pool

torch.set_num_threads(1)

# converted objects, keyed by the id of their original (kept alive beside
# them, so an id is never reused): the catalog converts once
_PORT_MEMO: dict = {}


def to_port(o):
    """A JAX-package object (SolverInput and everything it holds) -> the
    same object in the port's copy of its class."""
    if isinstance(o, (str, int, float, bool, type(None))):
        return o
    hit = _PORT_MEMO.get(id(o))
    if hit is not None and hit[0] is o:
        return hit[1]
    mod = type(o).__module__
    if mod.startswith("karpenter_tpu."):
        cls = getattr(importlib.import_module("karpenter_tpu_torch" + mod[len("karpenter_tpu"):]),
                      type(o).__name__)
        if dataclasses.is_dataclass(o):
            out = cls(**{f.name: to_port(getattr(o, f.name))
                         for f in dataclasses.fields(o) if f.init})
        elif isinstance(o, dict):
            out = cls()
            dict.update(out, {k: to_port(v) for k, v in o.items()})
        else:
            raise TypeError(f"cannot convert {type(o)}")
    elif isinstance(o, dict):
        out = {to_port(k): to_port(v) for k, v in o.items()}
    elif isinstance(o, (list, tuple, frozenset, set)):
        out = type(o)(to_port(x) for x in o)
    else:
        raise TypeError(f"cannot convert {type(o)}")
    if isinstance(o, list) or mod.startswith("karpenter_tpu.cloudprovider"):
        _PORT_MEMO[id(o)] = (o, out)
    return out


class _Captured(Exception):
    pass


def _capture(module, name: str, call):
    """Run `call` with module.<name> swapped for a function that raises
    with its arguments; returns (args, kwargs) of the first call."""
    saved = getattr(module, name)

    def grab(*args, **kwargs):
        raise _Captured(args, kwargs)

    setattr(module, name, grab)
    try:
        call()
    except _Captured as c:
        return c.args
    finally:
        setattr(module, name, saved)
    raise AssertionError(f"{name} was never called")


def _fleet_ladder(method: str) -> SolverInput:
    case = tdl.TestLadderParity()
    (inp,), _ = _capture(tdl, "_three_way", lambda: getattr(case, method)())
    return inp


def _fleet_relax_fuzz(seed: int) -> SolverInput:
    (inp,), _ = _capture(trd, "assert_relax_parity", lambda: trd.test_relax_fuzz(seed))
    return inp


def _fleet_anti_fuzz(seed: int) -> SolverInput:
    (inp,), _ = _capture(trd, "assert_relax_parity", lambda: trd.test_weighted_anti_fuzz(seed))
    return inp


def _fleet_weighted_anti(cls: str, method: str) -> SolverInput:
    case = getattr(trd, cls)()
    (inp,), _ = _capture(trd, "assert_relax_parity", lambda: getattr(case, method)())
    return inp


def _fleet_mixed_ladder() -> SolverInput:
    """A soft zone spread and the same spread required, on pods alike in all
    else: their level-0 signatures are one run with two ladders, which the
    ladder declines (the host loop serves it); the pool offers one zone."""
    sel = {"app": "m"}
    hard = TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE_LABEL, label_selector=sel)
    pods = [mkpod(f"s{i}", labels=dict(sel), topology_spread=[trd.sa_tsc(sel)]) for i in range(3)]
    pods += [mkpod(f"h{i}", labels=dict(sel), topology_spread=[hard]) for i in range(2)]
    one_zone = pool(extra=tdl.Requirements.of(
        tdl.Requirement.create(wk.ZONE_LABEL, tdl.IN, ["zone-1a"])))
    return SolverInput(pods=pods, nodes=[], nodepools=[one_zone], zones=ZONES)


def _fleet_hostname_affinity() -> SolverInput:
    """Weighted positive affinity on the hostname key (Q kind 2)."""
    pods = [mkpod(f"p{i}", labels={"app": "a"}, affinity_terms=[PodAffinityTerm(
        label_selector={"app": "a"}, topology_key=wk.HOSTNAME_LABEL, weight=10)])
        for i in range(3)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


LADDER_METHODS = (
    "test_schedule_anyway_spreads", "test_weighted_positive_pod_affinity",
    "test_preferred_node_affinity", "test_mixed_preference_kinds_one_solve",
    "test_ladder_composes_with_delta_decode",
)
# the admission-only (kind 3) antis: zone and capacity-type (V axis) and
# hostname (Q axis)
WEIGHTED_ANTI_METHODS = (
    ("TestWeightedAffinityOnDevice", "test_weighted_anti_on_device_admission_only"),
    ("TestWeightedAffinityOnDevice", "test_weighted_anti_relaxes_past_capacity"),
    ("TestWeightedAffinityOnDevice", "test_weighted_hostname_anti_on_device"),
    ("TestWeightedAffinityOnDevice", "test_weighted_hostname_anti_relaxes"),
    ("TestWeightedAntiCtAxis", "test_ct_weighted_anti_singletons"),
    ("TestWeightedAntiCtAxis", "test_zone_member_of_ct_kind3_sig_stays_on_device"),
)
FLEETS = {
    **{f"ladder_{m[5:]}": (lambda m=m: _fleet_ladder(m)) for m in LADDER_METHODS},
    **{f"anti_{m[5:]}": (lambda c=c, m=m: _fleet_weighted_anti(c, m))
       for c, m in WEIGHTED_ANTI_METHODS},
    **{f"relax_fuzz_{s}": (lambda s=s: _fleet_relax_fuzz(s)) for s in range(8)},
    **{f"weighted_anti_fuzz_{s}": (lambda s=s: _fleet_anti_fuzz(s)) for s in range(6)},
    "mixed_ladder": _fleet_mixed_ladder,
    "hostname_weighted_affinity": _fleet_hostname_affinity,
}


# -- kernel level: the plain ladder scan against ffd_solve_ladder -----------


def _captured_ladder(inp: SolverInput):
    """(run_ladder, host args, max_claims) of the ladder dispatch TPUSolver
    makes for `inp`, as numpy arrays."""
    (lad, *args), kw = _capture(jffd, "ffd_solve_ladder",
                                lambda: TPUSolver(sparse="off").solve(inp))
    return np.array(lad), tuple(np.array(a) for a in args), kw["max_claims"]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


# every fleet above that TPUSolver serves through one ladder dispatch and
# that adds a path: soft spreads, weighted positive affinity, preferred node
# affinity, their mix, kind-3 antis on the zone, capacity-type and hostname
# keys, weighted hostname affinity, fuzzed mixes
KERNEL_FLEETS = (
    "ladder_schedule_anyway_spreads", "ladder_weighted_positive_pod_affinity",
    "ladder_preferred_node_affinity", "ladder_mixed_preference_kinds_one_solve",
    "anti_weighted_anti_relaxes_past_capacity", "anti_weighted_hostname_anti_on_device",
    "anti_weighted_hostname_anti_relaxes", "anti_ct_weighted_anti_singletons",
    "anti_zone_member_of_ct_kind3_sig_stays_on_device", "hostname_weighted_affinity",
    "relax_fuzz_1", "relax_fuzz_5", "weighted_anti_fuzz_2", "weighted_anti_fuzz_4",
)


@pytest.mark.parametrize("zone_engine", [True, False], ids=["zoned", "fast"])
@pytest.mark.parametrize("name", KERNEL_FLEETS)
def test_ladder_scan_matches_jax(name, zone_engine):
    lad, args, M = _captured_ladder(FLEETS[name]())
    assert lad.shape[1] >= 2 and (lad >= 0).any()
    j = jffd.ffd_solve_ladder(lad, *args, max_claims=M, zone_engine=zone_engine)
    t = tffd.ffd_solve_ladder(array_to_torch(lad, "cpu"), *args_to_torch(args, "cpu"),
                              max_claims=M, zone_engine=zone_engine)
    tn = output_to_numpy(t)
    for k in ("take_e", "take_c", "leftover"):
        _equal(getattr(j, k), tn[k], k)
    for f in jffd.FFDState._fields:
        _equal(getattr(j.state, f), tn["state"][f], f)


def test_ladder_scan_walks_rungs():
    """A fleet whose soft spreads cannot hold (one zone): every pod after the
    first relaxes through rung 1 in the same dispatch, none is left over."""
    lad, args, M = _captured_ladder(FLEETS["ladder_schedule_anyway_spreads"]())
    out = tffd.ffd_solve_ladder(array_to_torch(lad, "cpu"), *args_to_torch(args, "cpu"),
                                max_claims=M, zone_engine=True)
    n = int(args[1].sum())
    assert int(out.leftover.sum()) == 0
    # the first base attempt places one pod (two events: the second places
    # none), then the walk alternates: rung 1 places a pod, the base places
    # none (one event)
    assert int(out.attempts) == 2 * (n - 1) and int(out.events) == n


# -- solver level: ladder and host loop against TPUSolver and the oracle ------


def _solve_both(inp: SolverInput, relax_ladder: bool):
    """(port solver, port result data, TPUSolver) or, when TPUSolver falls
    back to its oracle, (None, None, TPUSolver) after checking that the
    port declines."""
    tpu = TPUSolver(relax_ladder=relax_ladder)
    want = as_data(tpu.solve(inp))
    port = TorchSolver(device="cpu", relax_ladder=relax_ladder)
    if tpu.stats["fallback_solves"]:
        with pytest.raises(UnsupportedInput):
            port.solve(to_port(inp))
        return None, None, tpu
    got = as_data(port.solve(to_port(inp)))
    assert got == want
    ref = as_data(ReferenceSolver().solve(quantize_input(inp)))
    assert _parity_view(got) == _parity_view(ref)
    assert port.stats["device_solves"] == 1
    return port, got, tpu


@pytest.mark.parametrize("relax_ladder", [True, False], ids=["ladder", "host_loop"])
@pytest.mark.parametrize("name", sorted(FLEETS))
def test_relax_fleets_match_tpu_and_oracle(name, relax_ladder):
    port, _, tpu = _solve_both(FLEETS[name](), relax_ladder)
    if port is None:
        return
    for k in ("ladder_solves", "relax_dispatches", "ladder_rungs_used"):
        assert port.stats[k] == tpu.stats[k], (k, port.stats, tpu.stats)
    if relax_ladder and port.stats["ladder_solves"]:
        assert port.stats["relax_dispatches"] == 1


def test_config3_soft_equals_config3():
    """BASELINE config 3 with every spread ScheduleAnyway (satisfiable):
    one ladder dispatch, decisions equal config 3's, in both packages."""
    import bench
    import chip_smoke

    n = 2000
    port = TorchSolver(device="cpu")
    soft = as_data(port.solve(chip_smoke.build_config3_soft_input(n)))
    hard = as_data(TorchSolver(device="cpu").solve(chip_smoke.build_config3_input(n)))
    assert soft == hard and not soft["errors"]
    assert port.stats["ladder_solves"] == 1 and port.stats["relax_dispatches"] == 1
    jinp = bench.build_config3_input(n)
    for p in jinp.pods:
        p.topology_spread = [dataclasses.replace(t, when_unsatisfiable="ScheduleAnyway")
                             for t in p.topology_spread]
    tpu = TPUSolver()
    assert as_data(tpu.solve(jinp)) == soft
    assert tpu.stats["ladder_solves"] == 1


def _port_order(inp):
    from karpenter_tpu_torch.provisioning.scheduler import ffd_sort
    from karpenter_tpu_torch.solver import relax as trelax
    from karpenter_tpu_torch.solver.encode import quantize_input as tquantize

    q = tquantize(inp)
    items = trelax.plan(q)
    order = ffd_sort([p for p in q.pods if not p.scheduling_gated and p.node_name is None])
    return order, items


@pytest.mark.parametrize("name", ["config3_soft", "relax_walk", "surge_pref", "fleets"])
def test_materialize_pods_equals_materialize_pod(name):
    """The backend's run-sharing materialize_pods equals materialize_pod on
    every pod, at level 0 and at mixed per-pod levels, its seeded
    signatures included."""
    import random

    import chip_smoke
    from karpenter_tpu_torch.solver import relax as trelax
    from karpenter_tpu_torch.solver.backend import materialize_pods
    from karpenter_tpu_torch.solver.encode import _pod_signature, _pod_signature_uncached

    if name == "fleets":
        inputs = [to_port(make()) for make in FLEETS.values()]
    else:
        inputs = [getattr(chip_smoke, f"build_{name}_input")(1300)]
    rng = random.Random(4)
    n = 0
    for inp in inputs:
        order, items = _port_order(inp)
        if items is None:
            continue
        levels = {u: rng.randint(0, len(v)) for u, v in items.items()}
        for level in (lambda p: 0, lambda p: levels[p.meta.uid]):
            got = materialize_pods(order, items, level)
            want = [trelax.materialize_pod(p, items[p.meta.uid], level(p))
                    if p.meta.uid in items else p for p in order]
            assert got == want
            assert all(_pod_signature(p) == _pod_signature_uncached(p) for p in got)
            n += len(got)
    assert n > 400
