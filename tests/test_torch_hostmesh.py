"""The port's virtual host mesh (PERF row 17h) on the CPU, against the JAX
package.

- The protocol cases of tests/test_federation.py TestHostMesh: worker_main
  over in-memory pipes (ping, an unknown job's error reply, the solve job's
  A3 reply, a clean exit); _tree_concat; WorkerDead on a killed worker; an
  uneven scatter raises. A worker told to use CUDA where there is none
  exits (WorkerDead on its first call), and a pool on the card refuses to
  start without one: no worker carries on on the CPU. The worker entry
  (main, worker_main) defaults to the card and raises without one; the
  in-memory protocol case asks for the CPU.
- The port's `_handle_ffd_blocks` (K17's / K17s's plain versions on the
  CPU) equals the reference's `karpenter_tpu.parallel.hostmesh.
  _handle_ffd_blocks`, called in this process on the same job dict, lane
  for lane and leaf for leaf: dense and sparse, fast and zoned; a job
  without tables reads the ones resident under its ctx.
- `TorchSolver(device="cpu")` with `host_mesh=HostMeshPool(2, device="cpu")`
  decides as `TPUSolver()` and as `TorchSolver(shards=2)` under
  virtual_devices(2), with the same fix-up runs; a repeat solve of the same
  fleet ships no broadcast tables (ctx hit); another fleet of the same
  shapes ships its own tables (the context names their content).

Every output is an integer or a bit pattern: the tolerance is exact
equality. Every pool is closed in a finally (a module fixture).
"""

import collections
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.test_mesh_sharded_solve as jm
from karpenter_tpu.parallel import hostmesh as jhm
from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.utils.resources import Resources
from karpenter_tpu_torch.parallel import hostmesh as thm
from karpenter_tpu_torch.parallel import sharded as tsh
from karpenter_tpu_torch.solver.backend import TorchSolver
from tests.test_torch_jax_release import release_jax_executables  # noqa: F401 (autouse)
from tests.test_torch_relax import to_port
from tests.test_torch_sharded import constrained_input, nodes_input, random_input, zone_input
from tests.test_zone_device import ZONES, pool

torch.set_num_threads(1)


# ------------------------------------------------------------ the protocol


class TestProtocol:
    def test_worker_protocol_in_process(self):
        """worker_main against in-memory pipes: ping, a job-level error
        reply (the worker answers, it does not die), the solve job's A3
        reply, a clean exit."""
        inb = io.BytesIO()
        for job in ({"kind": "ping"}, {"kind": "nope"}, {"kind": "solve", "inp": None},
                    {"kind": "exit"}):
            thm._write_frame(inb, job)
        inb.seek(0)
        outb = io.BytesIO()
        assert thm.worker_main(stdin=inb, stdout=outb, device="cpu") == 0
        outb.seek(0)
        ping, err, solve = (thm._read_frame(outb) for _ in range(3))
        assert ping["ok"] and ping["result"]["pid"] > 0 and ping["result"]["device"] == "cpu"
        assert not err["ok"] and "ValueError" in err["error"]
        assert not solve["ok"] and "the solve job needs the oracle (ROADMAP A3)" in solve["error"]
        assert thm._read_frame(outb) is None

    def test_tree_concat_reassembles_named_tuples(self):
        T = collections.namedtuple("T", "a b")
        parts = [T(np.arange(2).reshape(2, 1), np.ones((2, 3))),
                 T(np.arange(2, 4).reshape(2, 1), np.zeros((2, 3)))]
        out = thm._tree_concat(parts)
        assert out.a.shape == (4, 1) and out.b.shape == (4, 3)
        np.testing.assert_array_equal(out.a[:, 0], [0, 1, 2, 3])

    def test_worker_death_is_typed(self):
        w = thm.WorkerProc("t-dead", device="cpu")
        try:
            assert w.call({"kind": "ping"})["pid"] > 0
            w.kill()
            w.proc.wait(timeout=60)
            with pytest.raises(thm.WorkerDead):
                w.call({"kind": "ping"})
        finally:
            w.close()

    def test_pool_rejects_undividable_blocks(self):
        pool_ = thm.HostMeshPool.__new__(thm.HostMeshPool)  # no subprocesses
        pool_.workers = [object(), object(), object()]
        with pytest.raises(ValueError, match="do not divide"):
            pool_.scatter_blocks(np.zeros((4, 2, 3)), np.zeros((4, 2)), rest=(), max_claims=8)

    def test_a_worker_without_a_card_raises(self):
        """A worker told to run on CUDA where there is none exits at start:
        its first call raises WorkerDead; it never solves on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        w = thm.WorkerProc("t-nogpu", device="cuda:0")
        try:
            with pytest.raises(thm.WorkerDead):
                w.call({"kind": "ping"})
        finally:
            w.close()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thm.HostMeshPool(2)

    def test_the_worker_entry_defaults_to_the_card(self):
        """The worker entry and the job loop run on the card unless asked
        for the CPU: without CUDA, main([]) and worker_main() raise before
        reading a frame (no worker falls back to the plain versions)."""
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thm.main([])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thm.worker_main(stdin=io.BytesIO(), stdout=io.BytesIO())


# ------------------------------------------------- the worker's lane program

LANE_FLEETS = {"fast": nodes_input, "zoned": constrained_input}


def _job(kind: str, sparse: bool, Nd: int = 4, first: int = 1, nb: int = 2, M: int = 64):
    """The ffd_blocks job the parent would send a worker that owns blocks
    [first, first + nb) of an Nd-block solve of LANE_FLEETS[kind]."""
    enc = jencode.encode(jencode.quantize_input(LANE_FLEETS[kind]()))
    host, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    rgb, rcb = jencode.mesh_run_blocks(np.asarray(host[0]), np.asarray(host[1]), Nd)
    sl = slice(first, first + nb)
    job = {"kind": "ffd_blocks", "rg": rgb[sl], "rc": rcb[sl],
           "rest": tuple(np.asarray(a) for a in host[2:]), "ctx": f"{kind}-{sparse}",
           "max_claims": M, "zone_engine": enc.V > 0, "sq": None, "sv": None}
    if sparse:
        rqi, rvi = jencode.sparse_run_tables(enc, dims["Sp"])
        Sblk = dims["Sp"] // Nd
        job["sq"] = np.ascontiguousarray(rqi.reshape(Nd, Sblk, -1))[sl]
        job["sv"] = np.ascontiguousarray(rvi.reshape(Nd, Sblk, -1))[sl]
    return job, enc


def _lanes_equal(j, t, what):
    for k in (f for f in j._fields if f != "state"):
        np.testing.assert_array_equal(np.asarray(getattr(j, k)), np.asarray(getattr(t, k)),
                                      err_msg=f"{what} {k}")
    for k in j.state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j.state, k)),
                                      np.asarray(getattr(t.state, k)), err_msg=f"{what} {k}")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", sorted(LANE_FLEETS))
def test_handle_ffd_blocks_matches_the_reference(kind, sparse):
    job, enc = _job(kind, sparse)
    assert (enc.V > 0) == (kind == "zoned")
    # the reference's lane closes its tables over a jit: they must be jax
    # arrays there (see test_reference_handler_needs_device_tables)
    want = jhm._handle_ffd_blocks(dict(job, rest=tuple(jnp.asarray(a) for a in job["rest"])),
                                  {}, {})
    cache = collections.OrderedDict()
    got = thm._handle_ffd_blocks(dict(job), cache, "cpu")
    assert got.take_e.shape[0] == 2
    _lanes_equal(want, got, f"{kind} sparse={sparse}")
    # a job without tables reads the ones resident under its ctx
    again = thm._handle_ffd_blocks(dict(job, rest=None), cache, "cpu")
    _lanes_equal(want, again, f"{kind} sparse={sparse} (ctx)")
    assert list(cache) == [job["ctx"]]


def test_reference_handler_needs_device_tables():
    """Reference finding (ROADMAP §C.16): the reference's worker indexes the
    numpy tables its parent ships (hostmesh.py:78-126, backend.py:2841)
    with traced values inside its jit, so every `ffd_blocks` job as
    TPUSolver(host_mesh=...) sends it fails; the port's worker takes them."""
    job, _ = _job("fast", False)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jhm._handle_ffd_blocks(dict(job), {}, {})
    assert thm._handle_ffd_blocks(dict(job), collections.OrderedDict(), "cpu").take_e.shape[0] == 2


# --------------------------------------------------------- the solver path


@pytest.fixture(scope="module")
def hostmesh_pool():
    p = thm.HostMeshPool(2, device="cpu")
    try:
        yield p
    finally:
        p.close()


HM_FLEETS = {"random": lambda: random_input(1), "nodes": nodes_input, "zone": zone_input,
             "constrained": constrained_input}


@pytest.mark.parametrize("name", sorted(HM_FLEETS))
def test_host_mesh_solver_decides_as_tpu_solver(name, hostmesh_pool):
    jinp = HM_FLEETS[name]()
    want = jbackend.TPUSolver().solve(jinp)
    h = TorchSolver(device="cpu")
    h.host_mesh = hostmesh_pool
    got = h.solve(to_port(jinp))
    jm._assert_same(want, got, name)
    assert h.stats["hostmesh_solves"] == 1 and h.stats["sharded_solves"] == 1
    with tsh.virtual_devices(2):
        s = TorchSolver(device="cpu", shards=2)
        jm._assert_same(want, s.solve(to_port(jinp)), f"{name} shards=2")
    assert s.stats["sharded_solves"] == 1
    assert h.stats["shard_fixup_runs"] == s.stats["shard_fixup_runs"]


def test_repeat_solve_ships_no_tables(hostmesh_pool):
    """The second solve of a fleet finds its tables resident (rest=None on
    the pipe); a fleet of the same shapes but other content ships its own."""
    jinp = random_input(2)
    h = TorchSolver(device="cpu")
    h.host_mesh = hostmesh_pool
    sent = lambda: sum(w.bytes_sent for w in hostmesh_pool.workers)  # noqa: E731
    b0 = sent()
    first = h.solve(to_port(jinp))
    cold = sent() - b0
    b1 = sent()
    second = h.solve(to_port(jinp))
    warm = sent() - b1
    assert first.placements == second.placements
    assert 0 < warm < cold // 4
    # same shapes, other requests (each pod 1 MiB more memory): its own
    # context
    pods = []
    for p in jinp.pods:
        req = Resources(p.requests)
        req["memory"] += 1 << 20
        pods.append(dataclasses.replace(p, requests=req))
    other = dataclasses.replace(jinp, pods=pods)
    b2 = sent()
    got = h.solve(to_port(other))
    assert sent() - b2 > warm
    jm._assert_same(jbackend.TPUSolver().solve(other), got, "same shapes, other tables")


def test_host_mesh_declines_a_tiny_fleet(hostmesh_pool):
    jinp = SolverInput(pods=[jm._mkpod("t0", "1", "1Gi")], nodes=[], nodepools=[pool()],
                       zones=ZONES)
    h = TorchSolver(device="cpu")
    h.host_mesh = hostmesh_pool
    jm._assert_same(jbackend.TPUSolver().solve(jinp), h.solve(to_port(jinp)), "tiny")
    assert h.stats["hostmesh_solves"] == 0 and h.stats["sharded_fallbacks"] == 1

