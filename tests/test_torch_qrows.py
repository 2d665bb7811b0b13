"""Inputs past the scan kernel's old static rows (ROADMAP §C.13) through the
port on the CPU, against the JAX package and the oracle.

The scan's per-run Q rows now lie in dynamic shared memory sized at launch,
and `check_kernel_limits` holds the card's limits on CUDA launches only: the
plain versions take any Q, R, Z and P.

- A fleet of 260 apps, each spreading its replicas one per node (a hostname
  anti-affinity on itself): Qp 264, past the old 256-row cap.
  `TorchSolver(device="cpu")` decides as `TPUSolver()` and as the oracle,
  through `solve`, the cohort entry (`solve_cohort_async`) and the batched
  consolidation evaluator.
- 65 weighted pools under a zone spread: Pp past the zoned scan's 64 pool
  rows, and a pod asking for 14 extended resources: R past 16; both stay
  static rows on the card.
- `check_kernel_limits` on a CUDA device against a monkeypatched row budget:
  24 B a Q row and 10 B a V row, a zoned fleet's Q rows trading against its
  V rows; the static caps (R, domain columns, pools) raise there too; on the
  CPU nothing raises.

Every output is an integer or a set of names: the tolerance is exact
equality.
"""

import pytest
import torch

from karpenter_tpu.disruption import batched as jbatched
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu_torch.disruption import batched as tbatched
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from karpenter_tpu_torch.solver.encode import encode, quantize_input
from tests.test_torch_batched import _verdict_data, materialize, node, universe
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_solver import as_data, build, check, pod

torch.set_num_threads(1)

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def hostname_apps(n: int, replicas: int = 1) -> list:
    """`n` apps of `replicas` pods (100m / 128Mi), each app's pods with a
    hostname anti-affinity on the app itself: one Q signature per app."""
    return [pod(f"a{i:03d}-{j}", cpu="100m", mem="128Mi", labels={"app": f"a{i:03d}"},
                aff=[({"app": f"a{i:03d}"}, HOST, True)])
            for i in range(n) for j in range(replicas)]


APPS_260 = dict(pods=hostname_apps(260), pools=[dict(name="default")])


def pools_65() -> dict:
    """65 weighted pools of four types each, and a zone-spread deployment
    (the zoned instance) beside plain pods: Pp past MAX_P 64."""
    types = ["m5.large", "m5.xlarge", "c5.large", "c5.xlarge"]
    pools = [dict(name=f"p{i:02d}", weight=i, types=types) for i in range(65)]
    sel = {"app": "w"}
    pods = [pod(f"w{i}", cpu="1", mem="2Gi", labels=sel, tsc=[(1, ZONE, sel)]) for i in range(9)]
    pods += [pod(f"x{i}", cpu="500m", mem="1Gi") for i in range(6)]
    return dict(pods=pods, pools=pools)


def _dims(spec):
    """(dims, host_args, zone) of a spec's encode, as the solve computes them."""
    enc = encode(quantize_input(build(spec, "karpenter_tpu_torch")))
    host_args, dims, _ = tbackend.host_kernel_args(enc, TorchSolver(device="cpu")._bucket)
    return dims, host_args, enc.V > 0


def test_hostname_apps_past_256_rows():
    """The smallest probed fleet past the old cap: 260 one-per-node apps
    (Qp 264) solve on the CPU, equal to TPUSolver() and the oracle."""
    dims, _, _ = _dims(APPS_260)
    assert dims["Qp"] > 256
    check(APPS_260)


def test_hostname_apps_replicas():
    """300 apps of 2 replicas: every app's second pod needs a node of its
    own, and the Q rows stay past the old cap."""
    check(dict(pods=hostname_apps(300, 2), pools=[dict(name="default")]), oracle=False)


def test_pools_past_64_rows():
    dims, _, zone = _dims(pools_65())
    assert zone and dims["Pp"] > tffd.MAX_P
    check(pools_65())


def test_resources_past_16_rows():
    """A pod asking for 14 extended resources beside cpu, memory and pods:
    R 17, past the scan's 16 static request rows on the card; on the CPU it
    solves (unschedulable: no type offers them) as TPUSolver() and the
    oracle decide."""
    extra = {f"example.com/r{i}": "1" for i in range(14)}
    spec = dict(pods=[pod("wide", extra=extra)] + [pod(f"p{i}") for i in range(4)],
                pools=[dict(name="default")])
    dims, _, _ = _dims(spec)
    assert dims["R"] > tffd.MAX_R
    check(spec)


def test_cohort_solves_the_260_app_fleet():
    """The cohort entry on the CPU: three members of the 260-app fleet fuse
    (no row limit there), each decided as its solo solve and as
    TPUSolver()."""
    s = TorchSolver(device="cpu")
    members = [build(APPS_260, "karpenter_tpu_torch") for _ in range(3)]
    outs = s.solve_cohort_async(members)()
    want = as_data(TPUSolver().solve(build(APPS_260, "karpenter_tpu")))
    for out in outs:
        assert not isinstance(out, Exception), out
        assert as_data(out) == want
    assert s.stats["fused_dispatches"] == 1


def test_batched_evaluator_solves_the_260_app_fleet():
    """The batched consolidation evaluator on a universe of 260 one-per-node
    apps over four candidate nodes: prepare takes it on the CPU and its
    verdicts equal the JAX evaluator's."""
    pods = hostname_apps(260)
    u = universe([node(f"n{i}", "zone-1a", cpu="16", mem="64Gi") for i in range(5)],
                 [dict(name="default")], {c: pods[c::4] for c in range(4)},
                 {c: f"n{c}" for c in range(4)})
    subsets = [[0], [0, 1], [2, 3], [0, 1, 2, 3]]
    ev = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
    prep = ev.prepare(*materialize(u, "karpenter_tpu_torch"))
    assert prep is not None
    assert prep.enc.Q > 256
    jv = jbatched.BatchedConsolidationEvaluator(TPUSolver()).evaluate(
        *materialize(u, "karpenter_tpu"), subsets)
    tv = ev.evaluate_prepared(prep, subsets)
    assert [_verdict_data(v) for v in tv] == [_verdict_data(v) for v in jv]


def test_card_limits_never_raise_on_the_cpu(monkeypatch):
    """Past every card limit at once, a CPU device checks nothing."""
    dims, host_args, zone = _dims(pools_65())
    monkeypatch.setattr(tffd, "MAX_R", 1)
    monkeypatch.setattr(tffd, "MAX_Z", 1)
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: 0)
    tbackend.check_kernel_limits(dims, host_args, zone, "cpu")
    tbackend.check_kernel_limits(dims, host_args, zone, torch.device("cpu"))


def test_row_budget_is_two_dimensional_on_the_card(monkeypatch):
    """On a CUDA device the launch-sized rows need 24 B a Q row and, zoned,
    10 B a V row: the check passes at exactly the budget and raises one
    byte below it, so a zoned fleet's Q rows trade against its V rows."""
    sel = {"app": "w"}
    spec = dict(pods=hostname_apps(20) + [pod(f"w{i}", labels=sel, tsc=[(1, ZONE, sel)])
                                          for i in range(6)],
                pools=[dict(name="default")])
    dims, host_args, zone = _dims(spec)
    assert zone and dims["Qp"] > 0 and dims["Vp"] > 0
    need = 24 * dims["Qp"] + 10 * dims["Vp"]
    assert tffd.scan_rows_bytes(dims["Qp"], dims["Qp"], dims["Vp"], dims["Vp"], True) == need
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need)
    tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: need - 1)
    with pytest.raises(UnsupportedInput, match="shared rows"):
        tbackend.check_kernel_limits(dims, host_args, zone, "cuda")
    # without the zoned branch the V rows take nothing
    tbackend.check_kernel_limits(dims, host_args, False, "cuda:0")
    dims_q, args_q, zone_q = _dims(APPS_260)
    assert not zone_q
    monkeypatch.setattr(tffd, "scan_rows_budget", lambda device: 24 * dims_q["Qp"] - 1)
    with pytest.raises(UnsupportedInput, match=f"Qp={dims_q['Qp']}"):
        tbackend.check_kernel_limits(dims_q, args_q, zone_q, "cuda")


@pytest.mark.parametrize("limit", ["MAX_R", "MAX_Z", "MAX_P"])
def test_static_caps_raise_on_the_card(limit, monkeypatch):
    """R, the domain columns and the pools stay static rows of the kernel:
    past them a CUDA launch is declined with a typed error, before the
    row budget is read."""
    dims, host_args, zone = _dims(pools_65())
    monkeypatch.setattr(tffd, limit, 0)

    def no_budget(device):
        raise AssertionError("the static caps come first")

    monkeypatch.setattr(tffd, "scan_rows_budget", no_budget)
    with pytest.raises(UnsupportedInput):
        tbackend.check_kernel_limits(dims, host_args, zone, "cuda")


def test_row_bytes_match_the_kernel_layout():
    """scan_rows_bytes mirrors csrc/ffd_kernels.cu: a 24-byte QRow over
    max(Q, Kq) Q rows, then with the zoned branch 6 B over max(V, Kv) V rows
    plus 4 B a vcol slot."""
    assert tffd.scan_rows_bytes(8, 0, 100, 0, False) == 192
    assert tffd.scan_rows_bytes(8, 0, 100, 0, True) == 192 + 600
    assert tffd.scan_rows_bytes(8, 16, 100, 120, True) == 24 * 16 + 6 * 120 + 480
    assert tffd.scan_rows_bytes(0, 0, 0, 0, False) == 0
    assert tffd.q_cap("cpu") is None and tffd.zone_v_cap("cpu") is None
    assert tffd.scan_rows_budget("cpu") is None


def test_hostname_apps_fleet_matches_the_chip_digest():
    """chip_smoke.py's hostname fleet at 1 000 apps of 3 replicas (Qp
    1 008): TorchSolver(device="cpu") solves it, and its decisions are the
    ones the chip run holds the card to (HOSTNAME_APPS_DIGEST)."""
    import hashlib

    import chip_smoke as cs

    inp = cs.build_hostname_wide_input(cs.HOSTNAME_APPS, cs.HOSTNAME_REPLICAS)
    got = cs.decisions(TorchSolver(device="cpu", max_claims=cs.MAX_CLAIMS).solve(inp))
    assert not got["errors"]
    assert hashlib.sha256(repr(got).encode()).hexdigest() == cs.HOSTNAME_APPS_DIGEST
