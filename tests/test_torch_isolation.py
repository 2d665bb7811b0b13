"""The port stands alone: no JAX, nothing of karpenter_tpu, and each copied
piece pinned to its original.

- a static scan of every import in karpenter_tpu_torch/** and chip_smoke.py;
- a solve, a batched consolidation probe and a convex solve and one-shot
  consolidation through the port in a fresh interpreter leave jax and every karpenter_tpu module out of sys.modules (a subprocess, because this test
  process has imported jax through tests/conftest.py), and so do a fused
  cohort through the serving pipeline and a staged (stream_run_events) solve;
- TorchSolver() with no device argument refuses to run without CUDA;
- the copies (ARG_SPEC, delta constants, argument partitions, the
  consolidation argument indices and batch bucket, the catalog,
  host_kernel_args and encode, relax_items / materialize_pod / plan,
  canonicalize_placements, the sparse tables' constants and SPARSE_ARG_SPEC,
  chip_smoke.py's copies of bench.py's input functions (the
  wide-constraint fleet included), config-5 universe and relax-ladder
  fleet, the streaming event constants and run_table_events, the cohort
  fuse key's layout, the pipeline's PROVISIONING / DISRUPTION) equal their
  originals on sample inputs.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.parallel import sharded as jsharded
from karpenter_tpu.solver.tpu import consolidate as jcons
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.parallel import sharded as tsharded
from karpenter_tpu_torch.solver import backend as tbackend
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.cuda import consolidate as tcons
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_torch_solver import CASES, build, pkg

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "karpenter_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in ("jax", "karpenter_tpu"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_matches_exact_package_names():
    assert _forbidden("karpenter_tpu") and _forbidden("karpenter_tpu.solver.encode")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("karpenter_tpu_torch.solver") and not _forbidden("jaxlib_like")


def test_port_solve_loads_no_jax():
    code = (
        "import sys\n"
        "from chip_smoke import build_e2e_input\n"
        "from karpenter_tpu_torch.solver.backend import TorchSolver\n"
        "res = TorchSolver(device='cpu').solve(build_e2e_input(300, 4))\n"
        "assert len(res.placements) == 300, len(res.placements)\n"
        "from chip_smoke import build_config5_universe\n"
        "from karpenter_tpu_torch.disruption.batched import BatchedConsolidationEvaluator\n"
        "ev = BatchedConsolidationEvaluator(TorchSolver(device='cpu'))\n"
        "prep = ev.prepare(*build_config5_universe(20, 10))\n"
        "vs = ev.evaluate_prepared(prep, [[0, 1], list(range(10))])\n"
        "assert [v.ok for v in vs] == [True, True], vs\n"
        "from chip_smoke import build_relax_walk_input\n"
        "lad = TorchSolver(device='cpu')\n"
        "res = lad.solve(build_relax_walk_input(24))\n"
        "assert len(res.placements) == 24 and lad.stats['ladder_solves'] == 1, lad.stats\n"
        "from chip_smoke import build_constraint_wide_input\n"
        "sp = TorchSolver(device='cpu')\n"
        "res = sp.solve(build_constraint_wide_input(480, 40))\n"
        "assert len(res.placements) == 480 and sp.stats['sparse_dispatches'] == 1, sp.stats\n"
        "dd = TorchSolver(device='cpu', device_decode=False)\n"
        "assert dd.solve(build_constraint_wide_input(480, 40)).placements == res.placements\n"
        "from chip_smoke import build_scenario, build_split_consolidation\n"
        "from karpenter_tpu_torch.solver.convex import ConvexSolver\n"
        "cv = ConvexSolver(TorchSolver(device='cpu'))\n"
        "res = cv.solve(build_scenario('rightsize'))\n"
        "assert len(res.claims) == 6 and cv.convex_stats['convex_solves'] == 1, cv.convex_stats\n"
        "prop = cv.consolidate_global(*build_split_consolidation())\n"
        "assert prop is not None and len(prop['delete']) == 3, prop\n"
        "from chip_smoke import build_input\n"
        "from karpenter_tpu_torch.solver.pipeline import SolveService\n"
        "co = TorchSolver(device='cpu')\n"
        "svc = SolveService(co)\n"
        "try:\n"
        "    ts = svc.submit_cohort([{'inp': build_input(60 + i), 'tenant_id': f't{i}'}\n"
        "                            for i in range(3)])\n"
        "    got = [len(t.result(timeout=120).placements) for t in ts]\n"
        "finally:\n"
        "    svc.close()\n"
        "assert got == [60, 61, 62], got\n"
        "assert co.stats['fused_dispatches'] == 1 and co.stats['fused_members'] == 3, co.stats\n"
        "st = TorchSolver(device='cpu')\n"
        "st.stream_run_events = True\n"
        "st.solve(build_input(64))\n"
        "assert len(st.solve(build_input(63)).placements) == 63\n"
        "assert st.stats['event_stage_hits'] == 1 and st.arena.stats['event_edits'] == 1, st.stats\n"
        "bad = [m for m in sys.modules if m in ('jax', 'karpenter_tpu')\n"
        "       or m.startswith(('jax.', 'karpenter_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.TorchSolver()


def test_constants_pinned():
    assert tffd.ARG_SPEC == jffd.ARG_SPEC
    assert (tffd.DELTA_HEADER_WORDS, tffd.DELTA_ENTRY_U16) == (
        jffd.DELTA_HEADER_WORDS, jffd.DELTA_ENTRY_U16)
    assert tbackend.STATIC_CORE_NAMES == jbackend.STATIC_CORE_NAMES
    assert tbackend.PER_SOLVE_NAMES == jbackend.PER_SOLVE_NAMES
    assert (tbackend.DELTA_CAP_QUANTUM, tbackend.DELTA_UNIQ_QUANTUM) == (
        jbackend.DELTA_CAP_QUANTUM, jbackend.DELTA_UNIQ_QUANTUM)
    for args in [(0, 1), (500, 1024), (50_000, 1024), (3, 64)]:
        assert tbackend.initial_claim_bucket(*args) == jbackend.initial_claim_bucket(*args)
    for args in [(50_000, 32, 8, 512), (70, 16, 32, 128)]:
        assert tbackend.delta_capacity(*args) == jbackend.delta_capacity(*args)
        Sp, Mb = args[1], args[3]
        assert tbackend.delta_uniq_capacity(Sp, Mb) == jbackend.delta_uniq_capacity(Sp, Mb)


def test_streaming_and_cohort_copies_pinned():
    """The streaming event constants and run_table_events, the cohort fuse
    key's layout (padded shapes and dtypes, the zone-engine flag, the claim
    bucket) and the pipeline's request classes equal the originals."""
    from karpenter_tpu.solver import encode_cache as jec
    from karpenter_tpu.solver import pipeline as jpipe
    from karpenter_tpu_torch.solver import encode_cache as tec
    from karpenter_tpu_torch.solver import pipeline as tpipe

    assert (tffd.EVENT_ENTRY_WORDS, tffd.EVENT_PAD_POS) == (
        jffd.EVENT_ENTRY_WORDS, jffd.EVENT_PAD_POS)
    assert (tpipe.PROVISIONING, tpipe.DISRUPTION) == (jpipe.PROVISIONING, jpipe.DISRUPTION)
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 9, 48).astype(np.int32), rng.integers(0, 9, 48).astype(np.int32)
    c, d = a.copy(), b.copy()
    c[[3, 40]] += 1
    d[[3, 7]] -= 2
    for mx in (0, 2, 3):
        j, t = jec.run_table_events(a, b, c, d, mx), tec.run_table_events(a, b, c, d, mx)
        assert (j is None and t is None) or np.array_equal(j, t)
    for name in ("hostname_q_kinds", "existing_nodes"):
        spec = CASES[name]
        jp = jbackend.TPUSolver()._cohort_prep(build(spec, "karpenter_tpu"))
        tp = tbackend.TorchSolver(device="cpu")._cohort_prep(build(spec, "karpenter_tpu_torch"))
        assert tp["fkey"] == jp["fkey"] and tp["M0"] == jp["M0"], name


def test_sparse_constants_pinned():
    """The sparse tables' constants, width bucketing and argument table
    equal the JAX package's (tests/test_torch_sparse.py pins the tables and
    the gate on fleets)."""
    for n in ("SPARSE_IDX_MULT", "SPARSE_IDX_FLOOR", "SPARSE_MIN_SIGS", "SPARSE_DENSITY_MAX"):
        assert getattr(tencode, n) == getattr(jencode, n), n
    for k in range(0, 70):
        assert tencode._sparse_width(k) == jencode._sparse_width(k)
    assert tffd.SPARSE_ARG_SPEC == jffd.SPARSE_ARG_SPEC


def test_consolidation_constants_pinned():
    for n in ("_RUN_COUNT", "_NODE_COMPAT", "_V_COUNT0", "_NODE_QM", "_NODE_QO"):
        assert getattr(tcons, n) == getattr(jcons, n), n
    for b in (0, 1, 5, 8, 9, 63, 511, 512, 513):
        assert tsharded.batch_bucket(b) == jsharded.batch_bucket(b)
        for mult in (1, 8):
            assert tsharded.batch_bucket(b, None, mult) == jsharded.batch_bucket(b, None, mult)
    # the JAX mesh form counts devices; the port passes the count itself
    mesh = jsharded.make_mesh()
    n_dev = int(mesh.devices.size)
    assert tsharded.batch_bucket(511, n_dev) == jsharded.batch_bucket(511, mesh)


def _req_data(reqs):
    return sorted((k, r.complement, sorted(r.values_list()), r.min_values) for k, r in reqs.items())


def test_catalog_copy_pinned():
    ja, to = pkg("karpenter_tpu").catalog, pkg("karpenter_tpu_torch").catalog
    assert len(ja) == len(to) > 700
    for a, b in zip(ja, to):
        assert a.name == b.name
        assert dict(a.capacity) == dict(b.capacity) and dict(a.overhead) == dict(b.overhead)
        assert _req_data(a.requirements) == _req_data(b.requirements)
        assert [dataclasses.astuple(o) for o in a.offerings] == [
            dataclasses.astuple(o) for o in b.offerings]


def _same(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        assert a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a == b, what


# encode fields that carry process-local identities (interning counters,
# cache revisions) rather than decisions
_IDENTITY_FIELDS = {"core_rev", "group_snums", "sig_epoch"}


def _encode_pair_pinned(jinp, tinp):
    je = jencode.encode(jencode.quantize_input(jinp))
    te = tencode.encode(tencode.quantize_input(tinp))
    names = [f.name for f in dataclasses.fields(je)]
    assert names == [f.name for f in dataclasses.fields(te)]
    for f in names:
        if f in _IDENTITY_FIELDS:
            continue
        a, b = getattr(je, f), getattr(te, f)
        if f == "group_pods":
            a = [[p.meta.uid for p in g] for g in a]
            b = [[p.meta.uid for p in g] for g in b]
        _same(a, b, f)
    ja, jdims, _ = jbackend.host_kernel_args(je, jbackend.TPUSolver._bucket)
    ta, tdims, _ = tbackend.host_kernel_args(te, tbackend.TorchSolver._bucket)
    assert jdims == tdims
    for n, a, b in zip(jffd.ARG_SPEC, ja, ta):
        _same(a, b, n)
    return je


@pytest.mark.parametrize("name", ["existing_nodes", "hostname_q_kinds", "config2_masks"])
def test_encode_and_kernel_args_pinned(name):
    _encode_pair_pinned(build(CASES[name], "karpenter_tpu"), build(CASES[name], "karpenter_tpu_torch"))


@pytest.mark.parametrize("config", ["config3", "config4", "mixed", "constraint_wide"])
def test_bench_builder_copies_pinned(config):
    """chip_smoke.py's copies of bench.py's constrained-input builders encode
    (V-axis sigs, domain columns, the mixed zone+ct layout included) and pad
    to the same kernel arguments as the originals."""
    import bench
    import chip_smoke

    name = f"build_{config}_input"
    n = 2600  # spans three deployments, so several groups and sigs
    je = _encode_pair_pinned(getattr(bench, name)(n), getattr(chip_smoke, name)(n))
    assert je.V > 0 and not je.group_fallback.any()
    assert je.v_axis == ("mixed" if config == "mixed" else "zone")


def test_zone_fuzz_53_copy_pinned():
    """chip_smoke.py's build_zone_fuzz_53_input is the tests' ROADMAP §C.1
    fleet (tests/test_torch_solver.py _zone_fuzz_53_cut): the same pods and
    nodes, and the same kernel arguments as the JAX package's encode of it."""
    import chip_smoke
    from tests.test_torch_solver import _zone_fuzz_53_cut

    spec = _zone_fuzz_53_cut()
    got = chip_smoke.build_zone_fuzz_53_input()
    want = build(spec, "karpenter_tpu_torch")
    assert got.pods == want.pods and got.nodes == want.nodes and got.zones == want.zones
    je = _encode_pair_pinned(build(spec, "karpenter_tpu"), got)
    assert je.V > 0 and len(got.pods) == 17


def test_config5_universe_copy_pinned():
    """chip_smoke.py's build_config5_universe equals bench.py's: the same
    candidates, pods and nodes, and the universe with every candidate pod
    pending encodes and pads to the same kernel arguments."""
    import bench
    import chip_smoke

    jinp, jpods, jnode = bench.build_config5_universe(40, 12)
    tinp, tpods, tnode = chip_smoke.build_config5_universe(40, 12)
    assert jnode == tnode
    assert {c: [p.meta.uid for p in ps] for c, ps in jpods.items()} == {
        c: [p.meta.uid for p in ps] for c, ps in tpods.items()}
    assert [n.id for n in jinp.nodes] == [n.id for n in tinp.nodes]
    je = _encode_pair_pinned(
        dataclasses.replace(jinp, pods=[p for ps in jpods.values() for p in ps]),
        dataclasses.replace(tinp, pods=[p for ps in tpods.values() for p in ps]))
    assert je.E == 1512 and je.V == 0


def test_relax_copy_pinned():
    """relax_items, materialize_pod at every rung and plan equal the JAX
    package's on the relax fleets of tests/test_torch_relax.py."""
    from karpenter_tpu.solver import relax as jrelax
    from karpenter_tpu_torch.solver import relax as trelax
    from tests.test_torch_relax import FLEETS, to_port

    rungs = 0
    for name, make in FLEETS.items():
        jinp = make()
        tinp = to_port(jinp)
        jq, tq = jencode.quantize_input(jinp), tencode.quantize_input(tinp)
        assert trelax.plan(tq) == jrelax.plan(jq), name
        for jp, tp in zip(jq.pods, tq.pods):
            items = jrelax.relax_items(jp)
            assert trelax.relax_items(tp) == items, (name, jp.meta.uid)
            for k in range(len(items or ()) + 1):
                assert trelax.materialize_pod(tp, items, k) == to_port(
                    jrelax.materialize_pod(jp, items, k)), (name, jp.meta.uid, k)
                rungs += 1
    assert rungs > 100


@pytest.mark.parametrize("name", ["relax_fuzz_0", "anti_weighted_anti_relaxes_past_capacity",
                                  "mixed_ladder"])
def test_canonicalize_placements_copy_pinned(name):
    """canonicalize_placements re-sorts the sequential oracle's raw result
    (uncanonicalized: zone budgets interleave targets) as the JAX one does."""
    from karpenter_tpu.provisioning.scheduler import Scheduler
    from tests.test_torch_relax import FLEETS, to_port
    from tests.test_torch_solver import as_data

    inp = jencode.quantize_input(FLEETS[name]())
    raw = Scheduler(inp).solve()
    want = jbackend.canonicalize_placements(inp, raw)
    got = tbackend.canonicalize_placements(to_port(inp), to_port(raw))
    assert as_data(got) == as_data(want)
    assert got.errors == want.errors


def test_relax_walk_builder_copy_pinned():
    """chip_smoke.py's build_relax_walk_input equals bench.py's relax-ladder
    fleet (_decode_relax_metrics part (b)), rebuilt here from its source
    lines, and encodes to the same kernel arguments."""
    import bench
    import chip_smoke
    from karpenter_tpu.api import wellknown as jwk
    from karpenter_tpu.api.objects import TopologySpreadConstraint
    from karpenter_tpu.scheduling.requirements import IN, Requirement, Requirements

    rinp = bench.build_input(300)
    for pl in rinp.nodepools:
        pl.requirements = pl.requirements.union(
            Requirements.of(Requirement.create(jwk.ZONE_LABEL, IN, ["zone-1a"])))
    for i, p in enumerate(rinp.pods):
        app = f"app-{i % 8}"
        p.meta.labels["app"] = app
        p.node_selector = {}
        p.topology_spread = [TopologySpreadConstraint(
            max_skew=1, topology_key=jwk.ZONE_LABEL, label_selector={"app": app},
            when_unsatisfiable="ScheduleAnyway")]
    import inspect

    src = inspect.getsource(bench._decode_relax_metrics)
    assert 'app = f"app-{i % 8}"' in src and 'when_unsatisfiable="ScheduleAnyway"' in src
    from tests.test_torch_relax import to_port

    tinp = chip_smoke.build_relax_walk_input(300)
    assert [to_port(p) for p in rinp.pods] == tinp.pods
    assert [to_port(pl.requirements) for pl in rinp.nodepools] == [
        pl.requirements for pl in tinp.nodepools]
    _encode_pair_pinned(rinp, tinp)


def test_port_arena_and_resume_load_no_jax():
    """The arena, the checkpointed scan and a suffix resume, then a
    universe adopted twice, in a fresh interpreter: still no jax and no
    karpenter_tpu module."""
    code = (
        "import dataclasses, sys\n"
        "from chip_smoke import build_input, build_config5_universe, with_tail\n"
        "from karpenter_tpu_torch.solver.backend import TorchSolver\n"
        "s = TorchSolver(device='cpu', arena=True, resume=True, ckpt_every=2, ckpt_slots=16)\n"
        "base = build_input(2600)\n"
        "s.solve(base)\n"
        "res = s.solve(with_tail(base, 30))\n"
        "assert len(res.placements) == 2630, len(res.placements)\n"
        "assert s.stats['resume_solves'] == 1 and s.stats['resume_runs_skipped'] == 2, s.stats\n"
        "assert s.ledger.solve['h2d_msgs'] == 3, s.ledger.solve\n"
        "from karpenter_tpu_torch.disruption.batched import BatchedConsolidationEvaluator\n"
        "ev = BatchedConsolidationEvaluator(s)\n"
        "u = build_config5_universe(20, 10)\n"
        "ev.prepare(*u); ev.prepare(*u)\n"
        "assert s.arena.stats['exact_hits'] == 1, s.arena.stats\n"
        "bad = [m for m in sys.modules if m in ('jax', 'karpenter_tpu')\n"
        "       or m.startswith(('jax.', 'karpenter_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_solver_defaults_pinned():
    """TorchSolver() defaults to TPUSolver()'s arena, resume, sparse and
    decode settings."""
    import inspect

    tp = inspect.signature(tbackend.TorchSolver.__init__).parameters
    jp = inspect.signature(jbackend.TPUSolver.__init__).parameters
    for n in ("max_claims", "relax_ladder", "arena", "resume", "ckpt_every", "ckpt_slots",
              "arena_budget_mb", "sparse", "device_decode"):
        assert tp[n].default == jp[n].default, n
    t, j = tbackend.TorchSolver(device="cpu"), jbackend.TPUSolver()
    assert (t.resume, t.ckpt_every, t.ckpt_slots) == (j.resume, j.ckpt_every, j.ckpt_slots)
    assert (t.arena.max_buckets, t.arena.max_ckpts_per_bucket, t.arena.budget_bytes) == (
        j.arena.max_buckets, j.arena.max_ckpts_per_bucket, j.arena.budget_bytes)
    assert not tbackend.TorchSolver(device="cpu", arena=False).resume


@pytest.mark.parametrize("K,n", [(1, 2), (2, 16), (3, 4), (16, 4)])
def test_ring_coverage_pinned(K, n):
    t = tbackend.TorchSolver(device="cpu", ckpt_every=K, ckpt_slots=n)
    j = jbackend.TPUSolver(ckpt_every=K, ckpt_slots=n)
    for Sp, S, base in ((16, 3, 0), (32, 24, 0), (48, 40, 0), (16, 8, 32), (32, 20, 4)):
        assert t._ring_coverage(Sp, S, base) == j._ring_coverage(Sp, S, base)


def test_run_identity_and_stitch_helpers_pinned():
    """run_identity / run_lcp on the same encodes, and the dense<->entry
    helpers of the resume stitch, equal their originals."""
    from karpenter_tpu.solver import encode_cache as jec
    from karpenter_tpu_torch.solver import encode_cache as tec

    idents = []
    for name in ("existing_nodes", "hostname_q_kinds", "config2_masks"):
        je = jencode.encode(jencode.quantize_input(build(CASES[name], "karpenter_tpu")))
        te = tencode.encode(tencode.quantize_input(build(CASES[name], "karpenter_tpu_torch")))
        # interned signature numbers are process-local: compare (group, count)
        # and the snum structure
        ji, ti = jec.run_identity(je), tec.run_identity(te)
        assert [x[1:] for x in ji] == [x[1:] for x in ti] and len(ji) == len(je.run_group)
        idents.append(ti)
    a = ((1, 0, 5), (2, 1, 4), (3, 2, 9))
    for b in (a, a[:2], a[:2] + ((3, 2, 8),), ((9, 0, 5),) + a[1:], ()):
        assert tec.run_lcp(a, b) == jec.run_lcp(a, b)
    rng = np.random.default_rng(0)
    for S, Ep, Mb in ((5, 8, 64), (12, 32, 128)):
        te_ = np.where(rng.random((S, Ep)) < 0.2, rng.integers(1, 9, (S, Ep)), 0).astype(np.int32)
        tc_ = np.where(rng.random((S, Mb)) < 0.05, rng.integers(1, 9, (S, Mb)), 0).astype(np.int32)
        ent = tbackend._entries_from_dense(te_, tc_, Ep)
        assert np.array_equal(ent, jbackend._entries_from_dense(te_, tc_, Ep))
        for got, want in zip(tbackend._dense_from_entries(ent, S, Ep, Mb),
                             jbackend._dense_from_entries(ent, S, Ep, Mb)):
            assert np.array_equal(got, want)
        assert np.array_equal(tbackend._dense_from_entries(ent, S, Ep, Mb)[0], te_)


def test_class_and_explain_constants_pinned():
    """The eviction and explain wires, the reason enum, the class budgets
    and the reason names equal the JAX package's."""
    from karpenter_tpu.obs import explain as jx
    from karpenter_tpu.solver import scheduling_class as jsc
    from karpenter_tpu_torch.obs import explain as tx
    from karpenter_tpu_torch.solver import scheduling_class as tsc

    for n in ("EVICT_HEADER_WORDS", "EVICT_ENTRY_U16", "EXPLAIN_REASONS",
              "EXPLAIN_HEADER_WORDS", "EXPLAIN_ENTRY_WORDS", "EXPLAIN_ARG_SPEC"):
        assert getattr(tffd, n) == getattr(jffd, n), n
    for g, k in ((1, 1), (8, 8), (1024, 8), (4, 40)):
        assert tffd.explain_words(g, k) == jffd.explain_words(g, k)
    for n in ("GANG_CLAIM_BUDGET", "MAX_EVICTIONS_PER_SOLVE", "INT32_MAX"):
        assert getattr(tsc, n) == getattr(jsc, n), n
    assert tx.REASON_NAMES == jx.REASON_NAMES
    import inspect

    assert inspect.signature(tx.configure) == inspect.signature(jx.configure)


def test_build_victim_tensors_pinned():
    """build_victim_tensors on the class fleet (and on nodes without bound
    pods) equals the JAX package's, array for array."""
    import bench
    from karpenter_tpu.solver import scheduling_class as jsc
    from karpenter_tpu_torch.solver import scheduling_class as tsc
    from tests.test_torch_relax import to_port

    inp = bench._gang_input(n_nodes=6, victims_per_node=3, n_high=4, n_gangs=2, gang_size=2)
    inp.nodes[0].bound_pods[1].evictable = False
    inp.nodes[1].bound_pods[0].priority = 7
    for nodes in (inp.nodes, inp.nodes[:0] + [dataclasses.replace(inp.nodes[2], bound_pods=[])]):
        for rkeys in (["cpu", "memory", "pods"], ["cpu", "ephemeral-storage", "memory"]):
            want = jsc.build_victim_tensors(nodes, rkeys)
            got = tsc.build_victim_tensors(to_port(nodes), rkeys)
            for a, b in zip(want[:4], got[:4]):
                _same(a, b, "victim tables")
            assert got[4] == want[4]


def test_explain_tables_pinned():
    """explain_tables of the port's encode equals the JAX package's on the
    encode cases and a fleet with spreads and affinity."""
    for name in ("existing_nodes", "hostname_q_kinds", "config2_masks"):
        je = jencode.encode(jencode.quantize_input(build(CASES[name], "karpenter_tpu")))
        te = tencode.encode(tencode.quantize_input(build(CASES[name], "karpenter_tpu_torch")))
        want, got = jencode.explain_tables(je), tencode.explain_tables(te)
        assert list(want) == list(got)
        for k in want:
            _same(np.asarray(want[k]), np.asarray(got[k]), k)
    import bench
    import chip_smoke

    je = jencode.encode(jencode.quantize_input(bench.build_config4_input(2600)))
    te = tencode.encode(tencode.quantize_input(chip_smoke.build_config4_input(2600)))
    want, got = jencode.explain_tables(je), tencode.explain_tables(te)
    assert want["group_topo"].any() or want["group_aff"].any()
    for k in want:
        _same(np.asarray(want[k]), np.asarray(got[k]), k)


@pytest.mark.parametrize("topology", [None, "topology.kubernetes.io/zone"])
def test_class_input_copy_pinned(topology):
    """chip_smoke.py's build_class_input equals bench.py's _gang_input (with
    every gang labelled for co-location on the class_zone cell), and the
    injected gang affinity equals the JAX package's."""
    import bench
    import chip_smoke
    from karpenter_tpu.api import wellknown as jwk
    from karpenter_tpu.solver import scheduling_class as jsc
    from karpenter_tpu_torch.solver import scheduling_class as tsc
    from tests.test_torch_relax import to_port

    kw = dict(n_nodes=5, victims_per_node=3, n_high=7, n_gangs=3, gang_size=4)
    want = bench._gang_input(**kw)
    if topology is not None:
        for p in want.pods:
            if jwk.GANG_LABEL in p.meta.labels:
                p.meta.labels[jwk.GANG_TOPOLOGY_LABEL] = topology
    got = chip_smoke.build_class_input(**kw, topology=topology)
    assert to_port(want) == got
    pods = list(got.pods)
    inj = tsc._inject_gang_affinity(pods)
    assert inj == to_port(jsc._inject_gang_affinity(list(want.pods)))
    assert (inj is pods) == (topology is None)


def test_port_class_explain_loads_no_jax():
    """A class-engaged solve (gang rollback + preemption through the device
    planner leg) with the explain plane on, in a fresh interpreter: no jax
    and no karpenter_tpu module."""
    code = (
        "import sys\n"
        "from chip_smoke import build_class_input\n"
        "from karpenter_tpu_torch.obs import explain\n"
        "from karpenter_tpu_torch.solver.backend import TorchSolver\n"
        "from karpenter_tpu_torch.solver.scheduling_class import ClassAwareSolver\n"
        "explain.configure(enabled=True)\n"
        "s = TorchSolver(device='cpu')\n"
        "caw = ClassAwareSolver(s)\n"
        "res = caw.solve(build_class_input(12, 4, 30, 5, 4))\n"
        "st = caw.class_stats\n"
        "assert st['gang_rounds'] == 1 and st['gangs_unschedulable'] == 1, st\n"
        "assert res.evictions and st['preemptions'] == len(res.evictions), st\n"
        "assert s.stats['explain_dispatches'] == 2, s.stats\n"
        "rec = explain.store().recent(1)[0]['record']\n"
        "assert rec['preemptions'] and rec['gangs']['job-doomed']['committed'] is False\n"
        "bad = [m for m in sys.modules if m in ('jax', 'karpenter_tpu')\n"
        "       or m.startswith(('jax.', 'karpenter_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_class_aware_default_device_needs_cuda():
    """ClassAwareSolver(TorchSolver()) — the operator's default composition —
    refuses to run without CUDA, as TorchSolver() does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    from karpenter_tpu_torch.solver.scheduling_class import ClassAwareSolver

    with pytest.raises(RuntimeError, match="CUDA"):
        ClassAwareSolver(tbackend.TorchSolver())


def test_convex_constants_pinned():
    """The convex backend's tuning, argument table, buckets and the
    invariant gate's copy equal the JAX package's."""
    from karpenter_tpu.solver import convex as jcv
    from karpenter_tpu_torch.solver import convex as tcv
    from karpenter_tpu_torch.solver.cuda import convex as tcc

    for n in ("_RHO", "_ETA0", "_ANNEAL", "_ETA_MAX", "_TAU", "_STAY_EPS", "CONVEX_ARG_SPEC",
              "CONVEX_STATICS"):
        assert getattr(tcv, n) == getattr(jcv, n), n
    for n in range(0, 70):
        assert tcv._bucket(n, 16, 16) == jcv._bucket(n, 16, 16)
    assert tcv.CONVEX_ARG_SPEC[:5] == ("run_req", "run_count", "cand_cap", "cand_cost", "feas")
    assert tcc.MAX_R == tffd.MAX_R
    assert tcv.PREWARM_BUCKETS == ((16, 16), (32, 32), (64, 64))  # convex.py:813
    j = jcv.ConvexSolver.__init__.__defaults__
    t = tcv.ConvexSolver.__init__.__defaults__
    assert j == t, (j, t)


def test_check_invariants_copy_pinned():
    """check_invariants reports the same violations as the JAX gate, on a
    valid result and on one with every kind of violation."""
    from karpenter_tpu.provisioning.scheduler import ClaimResult, SolverResult
    from karpenter_tpu.solver import resilient as jres
    from karpenter_tpu.solver.encode import quantize_input as jq
    from karpenter_tpu_torch.solver import resilient as tres
    from karpenter_tpu_torch.solver.encode import quantize_input as tq
    from tests.test_convex_backend import mknode
    from tests.test_solver_parity import ZONES, mkpod, pool
    from tests.test_torch_relax import to_port
    from karpenter_tpu.provisioning.scheduler import SolverInput
    from karpenter_tpu.utils.resources import Resources

    pods = [mkpod(f"p{i}", cpu="3", mem="1Gi") for i in range(5)]
    inp = SolverInput(pods=pods, nodes=[mknode("n1", cpu="4")], nodepools=[pool()], zones=ZONES)
    good = SolverResult(placements={"p0": ("node", "n1"), "p1": ("claim", 0)},
                        claims=[ClaimResult(nodepool="default", requirements=None,
                                            instance_type_names=[], pod_uids=["p1"],
                                            requests=Resources(), taints=[], hostname="c0")],
                        errors={"p2": "x"})
    bad = SolverResult(
        placements={"p0": ("node", "n1"), "p1": ("node", "n1"), "p2": ("node", "ghost"),
                    "p3": ("claim", 7), "zz": ("node", "n1"), "p4": ("rack", 1)},
        claims=[ClaimResult(nodepool="default", requirements=None, instance_type_names=[],
                            pod_uids=["p3", "p3"], requests=Resources(), taints=[],
                            hostname="c0")],
        errors={"p0": "x", "nobody": "y"})
    for res in (good, bad):
        want = jres.check_invariants(jq(inp), res)
        got = tres.check_invariants(tq(to_port(inp)), to_port(res))
        assert got == want
    assert not jres.check_invariants(jq(inp), good) and len(jres.check_invariants(jq(inp), bad)) >= 6


@pytest.mark.parametrize("name", ["uniform", "rightsize", "split"])
def test_quality_scenario_copy_pinned(name):
    """chip_smoke.py's build_scenario is tools/explain_diff.py's: the same
    pods, nodes and pools, encoding to the same kernel arguments."""
    import importlib.util

    import chip_smoke

    spec = importlib.util.spec_from_file_location("explain_diff", REPO / "tools" / "explain_diff.py")
    xd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(xd)
    want, got = xd.build_scenario(name), chip_smoke.build_scenario(name)
    assert [p.meta.uid for p in got.pods] == [p.meta.uid for p in want.pods]
    assert [n.id for n in got.nodes] == [n.id for n in want.nodes]
    assert [(p.name, p.weight) for p in got.nodepools] == [(p.name, p.weight) for p in want.nodepools]
    assert (got.zones, got.capacity_types) == (want.zones, want.capacity_types)
    _encode_pair_pinned(want, got)


def test_config5_consolidation_copy_pinned():
    """chip_smoke.py's build_config5_consolidation is bench.py's universe with
    every candidate pod pending and the candidates [(cand-j, 1.0, {cpj})],
    as the convex backend's one-shot pass takes it; and the split
    consolidation is bench.py _quality_run's."""
    import bench
    import chip_smoke

    jinp, jpods, jnode = bench.build_config5_universe(1_560, 40)
    tinp, cands = chip_smoke.build_config5_consolidation(1_560, 40)
    assert cands == [(jnode[j], 1.0, frozenset(p.meta.uid for p in jpods[j])) for j in range(40)]
    assert [p.meta.uid for p in tinp.pods] == [p.meta.uid for j in range(40) for p in jpods[j]]
    assert [n.id for n in tinp.nodes] == [n.id for n in jinp.nodes]
    je = _encode_pair_pinned(
        dataclasses.replace(jinp, pods=[p for j in range(40) for p in jpods[j]]), tinp)
    assert je.E == 1_560
    inp, scands = chip_smoke.build_split_consolidation()
    assert [n.id for n in inp.nodes] == ["c1", "c2", "c3", "surv"]
    assert scands == [(f"c{j}", 0.5, frozenset({f"m{j - 1}{k}" for k in range(2)}))
                      for j in range(1, 4)]
