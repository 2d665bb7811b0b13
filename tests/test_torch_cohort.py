"""The fused cross-tenant cohort dispatch of the port against the JAX package.

- `pad_batch` (K16's plain version) against the JAX `pad_batch`: n in
  {1, 3, 5} lanes padded to {1, 4, 8}, int32 / uint32 / bool arrays; a
  tuple at or past the bucket passes through as the same objects.
- `batched_solve` (K15's plain version, a loop of ffd_solve_plain over the
  lanes) against the JAX `batched_solve` on `make_mesh(1)`, on stacked
  `host_kernel_args` of B in {1, 2, 4} different members, both zone_engine
  values: every FFDOutput field equal.
- `TorchSolver(device="cpu").solve_cohort_async` against the JAX
  `TPUSolver().solve_cohort_async` and against solo solves, cohorts of
  {1, 2, 3, 4, 8} (tests/test_cohort.py's `_rand_inp` members): decisions,
  fused_dispatches / fused_members / device_solves, each member's billed
  h2d bytes against its solo upload, explain fingerprints. The JAX side
  runs on 8 host devices (tests/conftest.py), so its cohort batch rounds to
  a multiple of 8 where the port's is the next power of two; decisions and
  billed bytes do not depend on the pad lanes, which decode discards.
- the pad adds no upload byte; an ineligible member (a relax plan; a
  custom-key spread, which the port refuses and the reference routes to its
  fallback) rides solo; a poisoned lane fails alone; a lane that saturates
  its claim bucket replays solo; `ClassAwareSolver.solve_cohort_async`
  runs a gang member through the class path beside fused flat members.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.metrics.registry import TENANT_METER_H2D_BYTES
from karpenter_tpu.obs import explain as jx
from karpenter_tpu.parallel import sharded as jsharded
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import scheduling_class as jsc
from karpenter_tpu.solver.encode import encode as jencode
from karpenter_tpu.solver.encode import quantize_input as jquantize
from karpenter_tpu_torch.obs import explain as tx
from karpenter_tpu_torch.parallel import sharded as tsharded
from karpenter_tpu_torch.solver import scheduling_class as tsc
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput
from karpenter_tpu_torch.solver.convert import args_to_torch, array_to_torch, output_to_numpy
from tests.test_batched_consolidation import ZONES, mkpod, pool
from tests.test_cohort import _rand_inp
from tests.test_scheduling_class import gang_labels
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import to_port
from tests.test_torch_solver import as_data, build, pod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def lanes_split_on_one_device(monkeypatch):
    """The JAX reference's fused output (`parallel/sharded.batched_solve`,
    sharded over tests/conftest.py's 8 host devices) is fetched and put on
    one device before its backend splits it into lanes.

    Split on the mesh, each `a[k]` of each output leaf is an 8-device
    program with an all-reduce, dispatched back to back with the others;
    XLA's CPU collectives wait 40 s for all 8 participants of one program
    and then abort the process. On a loaded host (pytest-xdist workers on
    every core) the participants of the programs in flight starve each
    other of the client's threads, and a worker died in these tests (and in
    tests/test_cohort.py's, which share the programs). Gathered on one
    device, the split runs no collective. The fused solve, its values and
    every count this module compares stay as they were."""
    real = jsharded.batched_solve

    def gathered(mesh, args, **kw):
        out = real(mesh, args, **kw)
        return jax.device_put(jax.device_get(out), jax.devices()[0])

    monkeypatch.setattr(jsharded, "batched_solve", gathered)
    yield


# ------------------------------------------------------------ K16: pad_batch


def _lanes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(-50, 50, (n, 3, 2)).astype(np.int32),
        rng.integers(0, 2**32, (n, 5), dtype=np.uint64).astype(np.uint32),
        rng.random((n, 7)) < 0.5,
    )


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_pad_batch_matches_jax(n, batch):
    import jax.numpy as jnp

    host = _lanes(n, 10 * n + batch)
    jin = tuple(jnp.asarray(a) for a in host)
    tin = tuple(array_to_torch(a, "cpu") for a in host)
    jout = jsharded.pad_batch(jin, batch)
    tout = tsharded.pad_batch(tin, batch)
    if n >= batch:  # pass-through: the same objects
        assert all(a is b for a, b in zip(jout, jin))
        assert all(a is b for a, b in zip(tout, tin))
        return
    for j, t, h in zip(jout, tout, host):
        j = np.asarray(j)
        got = t.numpy().view(np.uint32) if h.dtype == np.uint32 else t.numpy()
        assert got.dtype == j.dtype and got.shape == j.shape == (batch,) + h.shape[1:]
        np.testing.assert_array_equal(got, j)
        np.testing.assert_array_equal(got[n:], np.broadcast_to(h[-1:], (batch - n,) + h.shape[1:]))
    assert tsharded.pad_batch((), batch) == ()


# ------------------------------------------------------- K15: batched_solve


def _member_spec(rng, tag: str, zone: bool) -> dict:
    """A small fleet with the shapes every member of its kind shares (one
    shape bucket): 2-3 apps of 1-3 pods; with `zone` each app spreads over
    the zones (V > 0)."""
    pods = []
    for a in range(rng.choice([2, 3])):
        cpu, mem = rng.choice(["100m", "250m", "500m"]), rng.choice(["256Mi", "512Mi"])
        for r in range(rng.choice([1, 2, 3])):
            kw = dict(labels={"app": f"{tag}-a{a}"})
            if zone:
                kw["tsc"] = [(1, "topology.kubernetes.io/zone", {"app": f"{tag}-a{a}"})]
            pods.append(pod(f"{tag}-a{a}-{r}", cpu=cpu, mem=mem, **kw))
    return dict(pods=pods, pools=[dict(name="default")])


@pytest.mark.parametrize("zone", [False, True])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_batched_solve_matches_jax(B, zone):
    rng = random.Random(31 * B + zone)
    hosts = []
    for i in range(B):
        enc = jencode(jquantize(build(_member_spec(rng, f"m{i}", zone), "karpenter_tpu")))
        assert (enc.V > 0) == zone
        hosts.append(jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)[0])
    stacked = tuple(np.stack([h[j] for h in hosts]) for j in range(len(hosts[0])))
    M = 64
    jo = jsharded.batched_solve(jsharded.make_mesh(1), stacked, max_claims=M, zone_engine=zone)
    to = output_to_numpy(tsharded.batched_solve(args_to_torch(stacked, "cpu"), max_claims=M,
                                                zone_engine=zone))
    for k in ("take_e", "take_c", "leftover"):
        j = np.asarray(getattr(jo, k))
        assert to[k].dtype == j.dtype and to[k].shape[0] == B
        np.testing.assert_array_equal(to[k], j)
    for f, t in to["state"].items():
        j = np.asarray(getattr(jo.state, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert int(to["take_c"].sum() + to["take_e"].sum()) > 0


# ------------------------------------------------------ the cohort dispatch


@pytest.fixture
def explain_on():
    for m in (jx, tx):
        m.configure(enabled=True, top_k=8)
    yield
    for m in (jx, tx):
        m.configure(enabled=False)


def _members(n: int, seed: int, tag: str):
    rng = random.Random(seed)
    npods = rng.choice([2, 3])
    return [dataclasses.replace(_rand_inp(rng, f"{tag}{n}-{i}", npods), tenant_id=f"{tag}{n}t{i}")
            for i in range(n)]


def _fp(store, uid: str):
    hits = store.by_pod(uid)
    assert len(hits) == 1, (uid, len(hits))
    assert hits[0]["fingerprint"] is not None
    return hits[0]["fingerprint"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_cohort_matches_jax_and_solo(n, explain_on):
    inps = _members(n, 100 + n, "co")
    tenants = [inp.tenant_id for inp in inps]
    jfused = jbackend.TPUSolver()
    h2d0 = {t: TENANT_METER_H2D_BYTES.value(tenant=t) for t in tenants}
    jouts = jfused.solve_cohort_async(inps)()
    jh2d = {t: TENANT_METER_H2D_BYTES.value(tenant=t) - h2d0[t] for t in tenants}
    fused = TorchSolver(device="cpu")
    touts = fused.solve_cohort_async([to_port(x) for x in inps])()
    assert not any(isinstance(o, BaseException) for o in touts), touts
    for s in (jfused, fused):
        assert s.stats["device_solves"] == n
        assert s.stats["fused_dispatches"] == (n > 1)
        assert s.stats["fused_members"] == (n if n > 1 else 0)
    for i in range(n):
        assert as_data(touts[i]) == as_data(jouts[i]), i
        uid = inps[i].pods[0].meta.uid
        assert _fp(tx.store(), uid) == _fp(jx.store(), uid), i
    fused_fp = {i: _fp(tx.store(), inps[i].pods[0].meta.uid) for i in range(n)}
    solo = TorchSolver(device="cpu")
    for i in range(n):
        ref = solo.solve(to_port(inps[i]))
        assert as_data(touts[i]) == as_data(ref), i
        assert tx.store().recent(1)[0]["fingerprint"] == fused_fp[i], i
        if n > 1:
            # each member is billed exactly the bytes its solo dispatch uploads
            assert fused.tenant_h2d_bytes[tenants[i]] == solo.ledger.solve["h2d_bytes"], i
            assert fused.tenant_h2d_bytes[tenants[i]] == jh2d[tenants[i]], i
    if n == 1:
        assert fused.tenant_h2d_bytes == {}  # a lone member rides solo


def test_cohort_padding_adds_zero_ledger_bytes():
    """3 members pad to 4 lanes (K16's plain version): the fused upload is
    exactly three members' bytes, as the JAX ledger counts them."""
    inps = _members(3, 7, "pad")
    solo = TorchSolver(device="cpu")
    solo.solve(to_port(inps[0]))
    member_bytes = solo.ledger.total["h2d_bytes"]
    assert member_bytes > 0
    fused = TorchSolver(device="cpu")
    outs = fused.solve_cohort_async([to_port(x) for x in inps])()
    assert not any(isinstance(o, BaseException) for o in outs)
    assert fused.stats["fused_members"] == 3
    assert fused.ledger.total["h2d_bytes"] == 3 * member_bytes
    j = jbackend.TPUSolver()
    j.solve_cohort_async(inps)()
    assert j.ledger.total["h2d_bytes"] == fused.ledger.total["h2d_bytes"]
    # a warm repeat of the same cohort adopts with zero upload
    fused.solve_cohort_async([to_port(x) for x in inps])()
    assert fused.ledger.solve["h2d_bytes"] == 0 and fused.stats["fused_dispatches"] == 2


def test_cohort_without_the_arena_matches():
    inps = _members(3, 11, "off")
    on = TorchSolver(device="cpu").solve_cohort_async([to_port(x) for x in inps])()
    off = TorchSolver(device="cpu", arena=False)
    outs = off.solve_cohort_async([to_port(x) for x in inps])()
    assert [as_data(o) for o in outs] == [as_data(o) for o in on]
    assert off.stats["fused_dispatches"] == 1
    assert off.ledger.solve["h2d_msgs"] == off.ledger.solve["h2d_arrays"] == 36


def _relax_member(tag: str) -> SolverInput:
    """A member with a Respect-mode preference (a ScheduleAnyway zone
    spread): it has a relax plan, so it rides its solo path."""
    from karpenter_tpu.api.objects import TopologySpreadConstraint

    pods = [dataclasses.replace(
        mkpod(f"{tag}-{i}", labels={"app": tag}),
        topology_spread=[TopologySpreadConstraint(
            max_skew=1, topology_key="topology.kubernetes.io/zone",
            label_selector={"app": tag}, when_unsatisfiable="ScheduleAnyway")])
        for i in range(3)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES, tenant_id=tag)


def _custom_key_member(tag: str) -> SolverInput:
    """A member spread over a custom topology key: fallback-class (the
    reference routes it to its fallback solver, the port refuses it)."""
    from karpenter_tpu.api.objects import TopologySpreadConstraint

    pods = [dataclasses.replace(
        mkpod(f"{tag}-{i}", labels={"app": tag}),
        topology_spread=[TopologySpreadConstraint(
            max_skew=1, topology_key="example.com/rack", label_selector={"app": tag})])
        for i in range(2)]
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES, tenant_id=tag)


def test_ineligible_members_ride_solo():
    flat = _members(3, 5, "el")
    inps = flat[:2] + [_relax_member("relax"), _custom_key_member("rack"), flat[2]]
    j = jbackend.TPUSolver()
    jouts = j.solve_cohort_async(inps)()
    t = TorchSolver(device="cpu")
    touts = t.solve_cohort_async([to_port(x) for x in inps])()
    assert t.stats["fused_dispatches"] == j.stats["fused_dispatches"] == 1
    assert t.stats["fused_members"] == j.stats["fused_members"] == 3
    for i in (0, 1, 2, 4):
        assert as_data(touts[i]) == as_data(jouts[i]), i
    assert t.stats["ladder_solves"] == 1  # the relax member's solo path
    assert isinstance(touts[3], UnsupportedInput), touts[3]
    assert not isinstance(jouts[3], BaseException)  # the reference's fallback


def test_poisoned_lane_fails_alone(monkeypatch):
    """A member whose lane decode raises gets that exception as its
    outcome; its co-members keep their fused results and the dispatch's
    ledger window closes. A dispatch that fails whole fails every fused
    member, and the solo rider still lands."""
    inps = [to_port(x) for x in _members(4, 21, "px")]
    poison = inps[1].pods[0].meta.uid
    real = TorchSolver._cohort_lane_finish

    def lane_finish(self, prep, *a):
        if any(p.meta.uid == poison for p in prep["inp"].pods):
            raise RuntimeError("poisoned lane")
        return real(self, prep, *a)

    monkeypatch.setattr(TorchSolver, "_cohort_lane_finish", lane_finish)
    t = TorchSolver(device="cpu")
    outs = t.solve_cohort_async(inps)()
    assert isinstance(outs[1], RuntimeError) and str(outs[1]) == "poisoned lane"
    solo = TorchSolver(device="cpu")
    for i in (0, 2, 3):
        assert as_data(outs[i]) == as_data(solo.solve(inps[i])), i
    assert t.stats["fused_members"] == 4 and t.stats["device_solves"] == 3
    assert t.ledger.solves == 1 and t.ledger.total["d2h_msgs"] == 3

    from karpenter_tpu_torch.parallel import sharded

    def boom(*a, **k):
        raise RuntimeError("dispatch lost")

    monkeypatch.setattr(sharded, "batched_solve", boom)
    rider = _relax_member("rider")
    outs = TorchSolver(device="cpu").solve_cohort_async(inps[:2] + [to_port(rider)])()
    assert [str(o) for o in outs[:2]] == ["dispatch lost"] * 2
    assert not isinstance(outs[2], BaseException)


def test_saturated_lane_replays_solo():
    """Two members at the 512-claim bucket: one needs 520 nodes (pods of
    100 CPUs, one a node), saturates its lane and replays through its solo
    path, whose claim bucket doubles; the other keeps its fused result."""
    big = SolverInput(pods=[mkpod(f"big-{i}", cpu="100", mem="1Gi") for i in range(520)],
                      nodes=[], nodepools=[pool()], zones=ZONES, tenant_id="big")
    small = SolverInput(pods=[mkpod(f"small-{i}", cpu="100m", mem="128Mi") for i in range(520)],
                        nodes=[], nodepools=[pool()], zones=ZONES, tenant_id="small")
    j = jbackend.TPUSolver()
    jouts = j.solve_cohort_async([big, small])()
    t = TorchSolver(device="cpu")
    touts = t.solve_cohort_async([to_port(big), to_port(small)])()
    assert t.stats["fused_dispatches"] == 1 and t.stats["fused_members"] == 2
    assert t.stats["claim_doublings"] == 1  # the replay's solo doubling
    assert len(touts[0].claims) == 520 and not touts[0].errors
    for i in range(2):
        assert as_data(touts[i]) == as_data(jouts[i]), i


def test_class_cohort_matches_jax():
    """A gang member (engaged: the class path) beside two flat members
    (fused through the inner backend's cohort entry)."""
    for m in (jsc, tsc):
        m.configure(preemption=True, gang=True)
    flat = _members(2, 41, "cls")
    gang = SolverInput(pods=[mkpod(f"g{r}", cpu="1", labels=gang_labels("job", 3))
                             for r in range(3)],
                       nodes=[], nodepools=[pool()], zones=ZONES, tenant_id="gang")
    inps = [flat[0], gang, flat[1]]
    jw = jsc.ClassAwareSolver(jbackend.TPUSolver())
    jouts = jw.solve_cohort_async(inps)()
    tw = tsc.ClassAwareSolver(TorchSolver(device="cpu"))
    touts = tw.solve_cohort_async([to_port(x) for x in inps])()
    for i in range(3):
        assert as_data(touts[i]) == as_data(jouts[i]), i
        assert touts[i].gangs_unschedulable == jouts[i].gangs_unschedulable
    assert tw.class_stats["class_solves"] == jw.class_stats["class_solves"] == 1
    assert tw.stats["fused_dispatches"] == 1 and tw.stats["fused_members"] == 2
