"""The port's multi-process mesh (PERF row 17m) on the CPU: the placement
helpers of parallel/sharded.py, a real two-process gloo solve, and the
two-level (dcn, ici) candidate mesh.

- The counterparts of tests/test_parallel_sharded.py TestProcessMesh, with
  the reference's messages: a single process degenerates to make_mesh; an
  uneven split, an oversubscribed grid and uneven per-process slot counts
  raise MeshConstructionError; one-sided shardings raise; the shard_map
  form and explicit shardings equal `fn`; put_process_sharded round-trips.
  `process_count` / `process_slot_counts` are monkeypatched, as the JAX
  tests monkeypatch `jax.process_count`.
- Two rank subprocesses join a gloo group at tcp://127.0.0.1:<free port>,
  each under virtual_devices(2) with TorchSolver(shards=4, device="cpu"),
  and solve three seeded fleets (chip_smoke.py's jax-free input functions): both
  ranks decide as TPUSolver() in this process, every solve sharded, each
  rank uploading only its two blocks; the config-5 evaluator on the
  (dcn, ici) grid over the ranks gives the verdicts of one process. An
  uneven rig (2 slots and 1) declines to the single-device path with
  `_process_mesh_error` set, the decisions unchanged. Neither rank loads
  jax or karpenter_tpu.
- make_candidate_mesh(slots, hosts=2) under virtual_devices(8) is a (2, 4)
  grid whose consolidation verdicts equal the flat mesh's and the JAX
  evaluator's on its own (2, 4) grid (TestTwoLevelMesh's forcing).

Every output is an integer, a bit pattern or a price read from the same
table: the tolerance is exact equality. Every subprocess wait has a
timeout; a rank still running at the end is killed.
"""

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import chip_smoke as cs
from karpenter_tpu.disruption import batched as jbatched
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.tpu import consolidate as jcons
from karpenter_tpu_torch.disruption import batched as tbatched
from karpenter_tpu_torch.parallel import sharded as tsh
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.solver.cuda import consolidate as tcons
from tests.test_torch_batched import FLEETS, _verdict_data, materialize
from tests.test_torch_jax_release import release_if_crowded

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _release_jax_executables():
    yield
    release_if_crowded()


# --------------------------------------------------------------- converters

_JAX_MEMO: dict = {}


def to_jax(o):
    """A port object (SolverInput and everything it holds) -> the same
    object in the JAX package's copy of its class."""
    if isinstance(o, (str, int, float, bool, type(None))):
        return o
    hit = _JAX_MEMO.get(id(o))
    if hit is not None and hit[0] is o:
        return hit[1]
    mod = type(o).__module__
    if mod.startswith("karpenter_tpu_torch."):
        cls = getattr(importlib.import_module("karpenter_tpu" + mod[len("karpenter_tpu_torch"):]),
                      type(o).__name__)
        if dataclasses.is_dataclass(o):
            out = cls(**{f.name: to_jax(getattr(o, f.name))
                         for f in dataclasses.fields(o) if f.init})
        elif isinstance(o, dict):
            out = cls()
            dict.update(out, {k: to_jax(v) for k, v in o.items()})
        else:
            raise TypeError(f"cannot convert {type(o)}")
    elif isinstance(o, dict):
        out = {to_jax(k): to_jax(v) for k, v in o.items()}
    elif isinstance(o, (list, tuple, frozenset, set)):
        out = type(o)(to_jax(x) for x in o)
    else:
        raise TypeError(f"cannot convert {type(o)}")
    if isinstance(o, list) or mod.startswith("karpenter_tpu_torch.cloudprovider"):
        _JAX_MEMO[id(o)] = (o, out)
    return out


def decisions(r) -> dict:
    """A SolverResult of either package as JSON-normal data."""
    return json.loads(json.dumps({
        "placements": dict(r.placements), "errors": sorted(r.errors),
        "claims": [[c.nodepool, sorted(c.instance_type_names), list(c.pod_uids)]
                   for c in r.claims]}))


# ------------------------------------------------------ TestProcessMesh twins


class TestProcessMesh:
    def test_single_process_degenerates_to_make_mesh(self):
        with tsh.virtual_devices(8):
            mesh, (lo, hi) = tsh.make_process_mesh(4, device="cpu")
        assert mesh.size == 4 and mesh.n_local == 4 and mesh.world == 1
        assert (lo, hi) == (0, 4)

    def test_uneven_shard_split_fails_closed(self, monkeypatch):
        monkeypatch.setattr(tsh, "process_count", lambda: 2)
        with tsh.virtual_devices(8), pytest.raises(
                tsh.MeshConstructionError, match="not a multiple of process_count=2"):
            tsh.make_process_mesh(3, device="cpu")

    def test_oversubscribed_processes_fail_closed(self, monkeypatch):
        monkeypatch.setattr(tsh, "process_count", lambda: 2)
        with tsh.virtual_devices(8), pytest.raises(
                tsh.MeshConstructionError, match="devices per process but processes hold"):
            tsh.make_process_mesh(32, device="cpu")

    def test_uneven_device_counts_fail_closed(self, monkeypatch):
        monkeypatch.setattr(tsh, "process_count", lambda: 2)
        monkeypatch.setattr(tsh, "process_slot_counts", lambda device="cuda": [2, 1])
        with pytest.raises(tsh.MeshConstructionError,
                           match="per-process device counts are uneven"):
            tsh.make_process_mesh(2, device="cpu")

    def test_process_mesh_layout_is_process_major(self, monkeypatch):
        """Rank 1 of 2 processes of 4 slots each, 8 shards: blocks [4, 8)
        on its own slots; the token carries the world size and the rank."""
        monkeypatch.setattr(tsh, "process_count", lambda: 2)
        monkeypatch.setattr(tsh, "process_index", lambda: 1)
        monkeypatch.setattr(tsh, "process_slot_counts", lambda device="cuda": [4, 4])
        with tsh.virtual_devices(4):
            mesh, (lo, hi) = tsh.make_process_mesh(8, device="cpu")
            single = tsh.make_mesh(4, "shards", device="cpu")
        assert (lo, hi) == (4, 8) and mesh.offset == 4 and mesh.size == 8
        assert mesh.n_local == 4 and mesh.world == 2 and mesh.rank == 1
        assert mesh.token != single.token
        assert [list(r) for r in tsh.slot_rows(mesh, 16)] == [list(range(8, 16))]

    def test_one_sided_shardings_fail_closed(self):
        with tsh.virtual_devices(4):
            mesh = tsh.make_mesh(4, device="cpu")
        sh = tsh.Placement(mesh, True)
        with pytest.raises(tsh.MeshConstructionError, match="one-sided"):
            tsh.mesh_sharded_call(mesh, lambda x: x, in_shardings=sh)
        with pytest.raises(tsh.MeshConstructionError, match="one-sided"):
            tsh.mesh_sharded_call(mesh, lambda x: x, out_shardings=sh)

    def test_shard_map_fallback_matches_plain_fn(self):
        with tsh.virtual_devices(4):
            mesh = tsh.make_mesh(4, axis="shards", device="cpu")
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        fn = lambda a: a * 2.0 + 1.0  # noqa: E731 -- per-shard body
        out = tsh.mesh_sharded_call(mesh, fn)(x)
        np.testing.assert_array_equal(np.asarray(out), fn(x))

    def test_explicit_shardings_match_plain_fn(self):
        with tsh.virtual_devices(4):
            mesh = tsh.make_mesh(4, axis="shards", device="cpu")
        sh = tsh.Placement(mesh, True)
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        fn = lambda a: a * 3.0 - 2.0  # noqa: E731
        out = tsh.mesh_sharded_call(mesh, fn, in_shardings=sh, out_shardings=sh)(x)
        np.testing.assert_array_equal(out.cpu().numpy(), fn(x))

    def test_put_process_sharded_roundtrip(self):
        with tsh.virtual_devices(4):
            mesh, (lo, hi) = tsh.make_process_mesh(4, device="cpu")
        arr = np.arange(4 * 5, dtype=np.int32).reshape(4, 5)
        dev = tsh.put_process_sharded(mesh, arr, lo, hi)
        assert len(dev) == len(mesh.physical) == 1
        np.testing.assert_array_equal(tsh.fetch_placed(mesh, dev), arr)

    def test_put_process_sharded_checks_the_local_partition(self, monkeypatch):
        """Under several processes only rows [lo, hi) are placed, and a
        partition wider than the local slots raises."""
        monkeypatch.setattr(tsh, "process_count", lambda: 2)
        with tsh.virtual_devices(2):
            mesh = tsh.Mesh(tsh.device_slots("cpu"), "shards", world=2, rank=1, offset=2,
                            global_size=4)
        arr = np.arange(4 * 3, dtype=np.int32).reshape(4, 3)
        got = tsh.put_process_sharded(mesh, arr, 2, 4)
        np.testing.assert_array_equal(tsh.fetch_placed(mesh, got), arr[2:4])
        with pytest.raises(tsh.MeshConstructionError, match="does not match the 2 local"):
            tsh.put_process_sharded(mesh, arr, 1, 4)

    def test_init_distributed_failure_is_typed(self):
        """A group that cannot form raises MeshConstructionError (in a
        subprocess, so the failed store's threads never live in a test
        worker)."""
        code = (
            "from karpenter_tpu_torch.parallel import sharded as tsh\n"
            "try:\n"
            "    tsh.init_distributed('127.0.0.1:1', 2, 1, timeout_s=2)\n"
            "except tsh.MeshConstructionError as e:\n"
            "    assert 'init_process_group failed' in str(e), e\n"
            "    assert tsh.process_count() == 1 and tsh.process_index() == 0\n"
            "    print('typed')\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=RANK_TIMEOUT_S)
        assert out.returncode == 0, out.stderr[-4000:]
        assert out.stdout.strip() == "typed"


# ------------------------------------------------------- two gloo ranks

RANK_CODE = r"""
import json, sys
import chip_smoke as cs
from karpenter_tpu_torch.parallel import sharded as tsh
from karpenter_tpu_torch.solver.backend import TorchSolver
from karpenter_tpu_torch.disruption.batched import BatchedConsolidationEvaluator
from karpenter_tpu_torch.solver.cuda import consolidate as tcons

addr, world, rank, slots = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
fleets, subsets = json.loads(sys.argv[5]), json.loads(sys.argv[6])


def decisions(r):
    return {"placements": dict(r.placements), "errors": sorted(r.errors),
            "claims": [[c.nodepool, sorted(c.instance_type_names), list(c.pod_uids)]
                       for c in r.claims]}


tsh.init_distributed(addr, world, rank)
try:
    out = {"decisions": [], "shard_bytes": [], "h2d_bytes": [], "d2h_bytes": []}
    with tsh.virtual_devices(slots):
        s = TorchSolver(device="cpu", shards=4)
        for kind, seed in fleets:
            out["decisions"].append(decisions(s.solve(getattr(cs, kind)(seed))))
            for k, key in (("h2d_shard_bytes", "shard_bytes"), ("h2d_bytes", "h2d_bytes"),
                           ("d2h_bytes", "d2h_bytes")):
                out[key].append(s.ledger.solve[k])
        out["stats"] = {k: s.stats[k] for k in
                        ("sharded_solves", "process_mesh_declines", "sharded_fallbacks")}
        out["error"] = s._process_mesh_error
        mesh = s._shard_mesh()
        out["mesh"] = None if mesh is None else [mesh.size, mesh.n_local, mesh.offset, mesh.world]
        ev = BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
        vs = ev.evaluate_prepared(ev.prepare(*cs.build_config5_universe(20, 10)), subsets)
        out["verdicts"] = [[v.ok, v.has_replacement, v.replacement_price,
                            v.replacement_type_count] for v in vs]
        cm = tcons.candidate_mesh("cpu")
        out["cmesh"] = [list(cm.axis), list(cm.shape), cm.n_local, cm.offset]
    out["modules"] = sorted(m for m in sys.modules if m in ("jax", "karpenter_tpu")
                            or m.startswith(("jax.", "karpenter_tpu.")))
finally:
    tsh.close_distributed()
print(json.dumps(out))
"""

FLEETS_3 = [("build_constrained_input", 3), ("build_zone_input", 5), ("build_zone_input", 6)]
SUBSETS = [[0, 1], list(range(10)), [3], [2, 5, 7], [9]]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(slots_per_rank) -> list:
    """Run RANK_CODE as len(slots_per_rank) gloo ranks; their JSON outputs
    in rank order."""
    addr = f"127.0.0.1:{_free_port()}"
    world = len(slots_per_rank)
    procs = []
    try:
        for rank, slots in enumerate(slots_per_rank):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CODE, addr, str(world), str(rank), str(slots),
                 json.dumps(FLEETS_3), json.dumps(SUBSETS)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env={**os.environ, "OMP_NUM_THREADS": "1"}))
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
    return [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]


@pytest.fixture(scope="module")
def single_process():
    """What one process decides: TPUSolver() on every fleet, and the port's
    config-5 verdicts without a group."""
    want = [decisions(TPUSolver().solve(to_jax(getattr(cs, kind)(seed))))
            for kind, seed in FLEETS_3]
    ev = tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
    vs = ev.evaluate_prepared(ev.prepare(*cs.build_config5_universe(20, 10)), SUBSETS)
    verdicts = [[v.ok, v.has_replacement, v.replacement_price, v.replacement_type_count]
                for v in vs]
    jev = jbatched.BatchedConsolidationEvaluator(TPUSolver())
    jv = jev.evaluate(*to_jax(cs.build_config5_universe(20, 10)), SUBSETS)
    assert [list(_verdict_data(v)) for v in jv] == verdicts
    return want, verdicts


def test_two_gloo_ranks_decide_as_tpu_solver(single_process):
    want, verdicts = single_process
    r0, r1 = run_ranks([2, 2])
    for r in (r0, r1):
        assert r["decisions"] == want
        assert r["stats"] == {"sharded_solves": 3, "process_mesh_declines": 0,
                              "sharded_fallbacks": 0}
        assert r["error"] is None
        assert r["verdicts"] == verdicts
        assert r["cmesh"] == [["dcn", "ici"], [2, 2], 2, 2 * (r is r1)]
        assert r["modules"] == []
    assert r0["mesh"] == [4, 2, 0, 2] and r1["mesh"] == [4, 2, 2, 2]
    # each rank uploaded its own two of the four run blocks
    for k in ("shard_bytes", "h2d_bytes", "d2h_bytes"):
        assert r0[k] == r1[k]
    with tsh.virtual_devices(4):
        s = TorchSolver(device="cpu", shards=4, arena=False)
        for i, (kind, seed) in enumerate(FLEETS_3):
            s.solve(getattr(cs, kind)(seed))
            assert r0["shard_bytes"][i] * 2 == s.ledger.solve["h2d_shard_bytes"]


def test_uneven_rig_declines_to_one_device(single_process):
    want, verdicts = single_process
    for r in run_ranks([2, 1]):
        assert r["decisions"] == want
        assert r["stats"]["sharded_solves"] == 0 and r["stats"]["process_mesh_declines"] == 1
        assert "per-process device counts are uneven" in r["error"]
        assert r["mesh"] is None
        assert r["verdicts"] == verdicts
        assert r["modules"] == []


# ------------------------------------------------- the (dcn, ici) grid


def test_two_level_candidate_mesh_matches_flat_and_jax(monkeypatch):
    """A (2, 4) grid in one process splits the slots contiguously; its
    verdicts equal the flat mesh's of the same 8 slots and the JAX
    evaluator's on its own (2, 4) grid, on a multi-candidate fleet and a
    config-5 universe."""
    u, subsets = FLEETS["kind2_multi_candidate"]
    cases = [(materialize(u, "karpenter_tpu_torch"), materialize(u, "karpenter_tpu"), subsets),
             (cs.build_config5_universe(20, 10), to_jax(cs.build_config5_universe(20, 10)),
              SUBSETS)]
    with tsh.virtual_devices(8):
        slots = tsh.device_slots("cpu")
        grid = tcons.make_candidate_mesh(slots, hosts=2)
        assert grid.axis == ("dcn", "ici") and grid.shape == (2, 4) and grid.size == 8
        assert grid.devices == slots and grid.token != tcons.make_candidate_mesh(slots).token
        flat = [tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
                .evaluate(*t, subs) for t, _, subs in cases]
        with monkeypatch.context() as m:
            m.setattr(tcons, "candidate_mesh", lambda device="cuda": grid)
            two = [tbatched.BatchedConsolidationEvaluator(TorchSolver(device="cpu"))
                   .evaluate(*t, subs) for t, _, subs in cases]
    old = jcons._MESH, jcons._MESH_INIT
    try:
        jcons._MESH = jcons.make_candidate_mesh(jax.devices()[:8], hosts=2)
        jcons._MESH_INIT = True
        jcons._sharded_ffd.cache_clear()
        jv = [jbatched.BatchedConsolidationEvaluator(TPUSolver()).evaluate(*j, subs)
              for _, j, subs in cases]
    finally:
        jcons._MESH, jcons._MESH_INIT = old
        jcons._sharded_ffd.cache_clear()
    for f, t, j in zip(flat, two, jv):
        assert [_verdict_data(v) for v in t] == [_verdict_data(v) for v in f] \
            == [_verdict_data(v) for v in j]
