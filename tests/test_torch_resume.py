"""The port's checkpointed scan and suffix resume against the JAX package.

Kernel level: the plain `ffd_solve_ckpt` equals the JAX `ffd_solve_ckpt`
in every FFDOutput field, every field of every ring slot and `prefix`, on
fast and zoned fleets, for (ckpt_every, n_ckpt) in {(1, 2), (2, 16),
(3, 4), (16, 4)}; each fleet has fewer runs than its padded run axis
(S < Sp = 16), so padded steps advance the slot schedule. The plain
`ffd_resume`, started from a JAX ring slot carried across by
solver/convert.py, equals the JAX `ffd_resume` in every field and leaves
its checkpoint untouched.

Solver level (tests/test_scan_resume.py's cases): TorchSolver(device="cpu",
ckpt_every=2, ckpt_slots=16) resumes on an append-tail and on seeded
random mutations, decides as a resume=False port solver and as
TPUSolver(ckpt_every=2, ckpt_slots=16), and counts the same resume_solves,
resume_runs_skipped and ledger bytes; an exact repeat stays a zero-upload
exact hit; invalidate_arena() drops the ring; three resumes in a row stay
equal to cold. Every output is an integer or a bit pattern: the tolerance
is exact equality.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from karpenter_tpu.provisioning.scheduler import SolverInput
from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver.backend import TPUSolver
from karpenter_tpu.solver.encode import encode, quantize_input
from karpenter_tpu.solver.tpu import ffd as jffd
from karpenter_tpu_torch.solver.backend import TorchSolver, initial_claim_bucket
from karpenter_tpu_torch.solver.convert import (
    args_to_torch,
    output_to_numpy,
    ring_to_numpy,
    ring_to_torch,
    state_to_numpy,
)
from karpenter_tpu_torch.solver.cuda import ffd as tffd
from tests.test_solver_parity import ZONES, mkpod, pool
from tests.test_torch_relax import to_port
from tests.test_torch_ffd import SCAN_CASES
from tests.test_torch_solver import ZONE_CASES, as_data, build

torch.set_num_threads(1)

M = 64

KERNEL_FLEETS = {
    "fast_fleet1": (SCAN_CASES["fleet_1"], False),
    "fast_fleet2": (SCAN_CASES["fleet_2"], False),
    "zoned_residue": (ZONE_CASES["spread_residue_drains"], True),
    "zoned_mixed": (ZONE_CASES["mixed_zone_and_ct"], True),
}
CKPT = [(1, 2), (2, 16), (3, 4), (16, 4)]


def _host_args(spec: dict, zone: bool):
    enc = encode(quantize_input(build(spec, "karpenter_tpu")))
    assert not enc.group_fallback.any() and (enc.V > 0) == zone
    args, dims, _ = jbackend.host_kernel_args(enc, jbackend.TPUSolver._bucket)
    assert dims["Sp"] == 16 and 3 <= dims["S"] < 16, dims  # padded steps in the schedule
    return args, dims


def _equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _equal_output(j, t):
    tn = output_to_numpy(t)
    for k in ("take_e", "take_c", "leftover"):
        _equal(getattr(j, k), tn[k], k)
    for f in jffd.FFDState._fields:
        _equal(getattr(j.state, f), tn["state"][f], f)


def _equal_ring(jr, tr):
    rn = ring_to_numpy(tr)
    for f in jffd.FFDState._fields:
        _equal(getattr(jr.states, f), rn["states"][f], f"ring.{f}")
    _equal(jr.prefix, rn["prefix"], "prefix")


@pytest.mark.parametrize("K,n", CKPT, ids=[f"K{k}n{n}" for k, n in CKPT])
@pytest.mark.parametrize("name", sorted(KERNEL_FLEETS))
def test_ckpt_scan_matches_jax(name, K, n):
    spec, zone = KERNEL_FLEETS[name]
    args, dims = _host_args(spec, zone)
    jo, jr = jffd.ffd_solve_ckpt(*args, max_claims=M, zone_engine=zone, ckpt_every=K, n_ckpt=n)
    to, tr = tffd.ffd_solve_ckpt(*args_to_torch(args, "cpu"), max_claims=M, zone_engine=zone,
                                 ckpt_every=K, n_ckpt=n)
    _equal_output(jo, to)
    _equal_ring(jr, tr)
    # the schedule ran past the real runs: some slot holds a padded step
    assert int(np.asarray(jr.prefix).max()) > dims["S"]
    # and the checkpointed scan decides as the plain one
    _equal_output(jo, tffd.ffd_solve(*args_to_torch(args, "cpu"), max_claims=M, zone_engine=zone))


@pytest.mark.parametrize("name", sorted(KERNEL_FLEETS))
def test_resume_from_jax_ring_slot_matches_jax(name):
    spec, zone = KERNEL_FLEETS[name]
    args, dims = _host_args(spec, zone)
    K, n = 2, 16
    jo, jr = jffd.ffd_solve_ckpt(*args, max_claims=M, zone_engine=zone, ckpt_every=K, n_ckpt=n)
    S = dims["S"]
    k = 2 * ((S - 1) // 2)  # the last even position inside the real runs
    slot = k // K - 1
    assert int(np.asarray(jr.prefix)[slot]) == k
    jinit = jffd.FFDState(*(a[slot] for a in jr.states))
    sg = np.zeros(16, np.int32)
    sc = np.zeros(16, np.int32)
    sg[: S - k] = args[0][k:S]
    sc[: S - k] = args[1][k:S]
    suffix = (sg, sc) + tuple(args[2:])
    jso, jsr = jffd.ffd_resume(jinit, *suffix, max_claims=M, zone_engine=zone,
                               ckpt_every=K, n_ckpt=n)
    tinit = ring_to_torch(jr, "cpu").states
    tinit = tffd.FFDState(*(f[slot] for f in tinit))
    before = state_to_numpy(tinit)
    tso, tsr = tffd.ffd_resume(tinit, *args_to_torch(suffix, "cpu"), max_claims=M,
                               zone_engine=zone, ckpt_every=K, n_ckpt=n)
    _equal_output(jso, tso)
    _equal_ring(jsr, tsr)
    # the suffix's final carry is the cold solve's
    tn = output_to_numpy(tso)
    for f in jffd.FFDState._fields:
        _equal(getattr(jo.state, f), tn["state"][f], f)
    # the checkpoint itself is left as it was (the scan runs on copies)
    for f, a in state_to_numpy(tinit).items():
        _equal(before[f], a, f)


def test_ring_arguments_checked():
    args, _ = _host_args(KERNEL_FLEETS["fast_fleet1"][0], False)
    targs = args_to_torch(args, "cpu")
    with pytest.raises(ValueError):
        tffd.ffd_solve_ckpt(*targs, max_claims=M, ckpt_every=0)
    out, _ = tffd.ffd_solve_ckpt(*targs, max_claims=M)
    bad = out.state._replace(c_cum=out.state.c_cum[:, :1])
    with pytest.raises(ValueError):
        tffd.ffd_resume(bad, *targs, max_claims=M)


# -- solver level: tests/test_scan_resume.py's cases ---------------------------

N_SPECS = 24


def _fleet(rng=None, n_specs=N_SPECS, prefix="p"):
    """n_specs distinct pod sizes -> ~n_specs FFD runs; spec 0 is the
    smallest, the LAST run in FFD order."""
    pods = []
    for k in range(n_specs):
        count = rng.randrange(3, 8) if rng else 4
        for j in range(count):
            pods.append(mkpod(f"{prefix}{k:02d}-{j}", cpu=f"{100 + 7 * k}m",
                              mem=f"{64 + 16 * k}Mi"))
    return SolverInput(pods=pods, nodes=[], nodepools=[pool()], zones=ZONES)


def _add_replica(inp, k, uid):
    """A new pod with spec k's signature: one run's count changes, the
    signature universe does not."""
    pods = list(inp.pods) + [mkpod(uid, cpu=f"{100 + 7 * k}m", mem=f"{64 + 16 * k}Mi")]
    return dataclasses.replace(inp, pods=pods)


def _del_replica(inp, k, prefix="p"):
    name = f"{prefix}{k:02d}-0"
    pods = [p for p in inp.pods if p.meta.name != name]
    assert len(pods) == len(inp.pods) - 1
    return dataclasses.replace(inp, pods=pods)


def _mknode(name="n1", zone="zone-1a"):
    from karpenter_tpu.api import wellknown as wk
    from karpenter_tpu.provisioning.scheduler import ExistingNode
    from karpenter_tpu.utils.resources import Resources

    free = Resources.parse({"cpu": "8", "memory": "32Gi"})
    free["pods"] = 110
    return ExistingNode(
        id=name,
        labels={wk.ZONE_LABEL: zone, wk.HOSTNAME_LABEL: name,
                wk.CAPACITY_TYPE_LABEL: "on-demand", wk.ARCH_LABEL: "amd64",
                wk.OS_LABEL: "linux"},
        taints=[], free=free,
    )


_STATS = ("resume_solves", "resume_runs_skipped")
_LEDGER = ("h2d_bytes", "h2d_arrays", "h2d_msgs", "d2h_bytes", "d2h_msgs")


class _Trio:
    """The warm port solver, a resume=False port solver and the warm JAX
    solver, driven through one solve sequence: decisions, resume stats,
    stale sets and per-solve ledgers must agree at every step."""

    def __init__(self):
        self.warm = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
        self.cold = TorchSolver(device="cpu", resume=False)
        self.tpu = TPUSolver(ckpt_every=2, ckpt_slots=16)

    def solve(self, inp, tag=""):
        tinp = to_port(inp)
        got = as_data(self.warm.solve(tinp))
        assert got == as_data(self.cold.solve(tinp)), f"{tag}: resumed != cold"
        assert got == as_data(self.tpu.solve(inp)), f"{tag}: port != TPUSolver"
        for k in _STATS:
            assert self.warm.stats[k] == self.tpu.stats[k], (tag, k, self.warm.stats,
                                                             self.tpu.stats)
        assert self.warm.arena.last_stale == self.tpu.arena.last_stale, tag
        for k in _LEDGER:
            assert self.warm.ledger.solve[k] == self.tpu.ledger.solve[k], (
                tag, k, self.warm.ledger.solve, self.tpu.ledger.solve)
        return got


def test_append_tail_resumes_and_matches_cold():
    """Appending a replica of the smallest spec changes only the LAST run's
    count: the warm solver resumes, skipping a non-trivial prefix."""
    inp = _fleet()
    t = _Trio()
    t.solve(inp, "baseline")
    t.solve(_add_replica(inp, 0, "tail-0"), "append-tail")
    assert t.warm.stats["resume_solves"] == 1
    assert t.warm.stats["resume_runs_skipped"] > 0
    assert t.warm.resume_hit_rate == 0.5 == t.tpu.resume_hit_rate


def test_resume_off_never_resumes():
    inp = _fleet()
    for s in (TorchSolver(device="cpu", resume=False), TorchSolver(device="cpu", arena=False)):
        s.solve(to_port(inp))
        s.solve(to_port(_add_replica(inp, 0, "tail-0")))
        assert s.stats["resume_solves"] == 0 and not s.resume


@pytest.mark.parametrize("trial", range(8))
def test_random_mutations_resume_identical_to_cold(trial):
    """Seeded fleets and mutation classes: the warm port solver decides as
    the cold one and as TPUSolver at every step, with equal resume stats;
    a node-table change rewrites non-run args and a pod count that crosses
    a claim-bucket edge changes M0: both run cold."""
    rng = random.Random(0xC5 + trial)
    inp = _fleet(rng, prefix=f"t{trial}x")
    kind = ("append_tail", "mid_insert", "delete", "node_change")[trial % 4]
    if kind == "append_tail":
        mut = _add_replica(inp, 0, f"t{trial}-tail")
    elif kind == "mid_insert":
        k = rng.randrange(4, N_SPECS - 4)
        mut = _add_replica(inp, k, f"t{trial}-mid{k}")
    elif kind == "delete":
        mut = _del_replica(inp, rng.randrange(2, N_SPECS - 2), prefix=f"t{trial}x")
    else:
        mut = dataclasses.replace(inp, nodes=[_mknode(f"t{trial}-n")])
    t = _Trio()
    t.solve(inp, f"{trial}:{kind}:base")
    t.solve(mut, f"{trial}:{kind}:mut")
    # a mutation resumes unless it moves the node table or the claim bucket
    same_m = initial_claim_bucket(len(inp.pods), 1024) == initial_claim_bucket(len(mut.pods), 1024)
    assert t.warm.stats["resume_solves"] == int(kind != "node_change" and same_m), (
        kind, t.warm.stats)


def test_exact_repeat_stays_zero_upload_exact_hit():
    s = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
    inp = to_port(_fleet())
    s.solve(inp)
    s.solve(inp)
    assert s.stats["resume_solves"] == 0
    assert s.ledger.solve["h2d_bytes"] == 0 and s.ledger.solve["h2d_msgs"] == 0
    assert s.ledger.outcomes["exact_hit"] == 1


def test_resumed_solve_uploads_only_suffix_runs():
    """The resumed dispatch re-uploads the stale run entry (one packed
    message) and the two suffix run arrays, nothing else."""
    from karpenter_tpu_torch.solver.cuda.ffd import ARG_INDEX

    s = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
    inp = _fleet()
    s.solve(to_port(inp))
    full = dict(s.ledger.solve)
    s.solve(to_port(_add_replica(inp, 0, "tail-0")))
    assert s.stats["resume_solves"] == 1
    stale = s.arena.last_stale
    assert set(stale) <= {ARG_INDEX["run_group"], ARG_INDEX["run_count"]} and stale
    S = N_SPECS
    k = s.stats["resume_runs_skipped"]
    Sp, Sp2 = 32, max(16, -(-(S - k) // 16) * 16)
    assert s.ledger.solve["h2d_bytes"] == 4 * (len(stale) * Sp + 2 * Sp2) < full["h2d_bytes"]
    assert s.ledger.solve["h2d_arrays"] == len(stale) + 2
    assert s.ledger.solve["h2d_msgs"] == 3
    assert s.ledger.outcomes["full_upload"] == 1 and s.ledger.outcomes["delta_upload"] == 1


def test_invalidate_arena_drops_the_ring():
    s = TorchSolver(device="cpu", ckpt_every=2, ckpt_slots=16)
    inp = _fleet()
    s.solve(to_port(inp))
    assert s.arena._ckpts
    s.invalidate_arena()
    assert not s.arena._ckpts and not s.arena._buckets
    tail = to_port(_add_replica(inp, 0, "tail-0"))
    got = as_data(s.solve(tail))
    assert s.stats["resume_solves"] == 0 and s.arena.stats["full_uploads"] == 2
    assert got == as_data(TorchSolver(device="cpu", resume=False).solve(tail))
    s.solve(to_port(_add_replica(_add_replica(inp, 0, "tail-0"), 0, "tail-1")))
    assert s.stats["resume_solves"] == 1  # the ring is harvested again


def test_three_resumes_in_a_row_stay_cold_equal():
    """Each mutation lies past the previous resume point, so every solve
    resumes from the previous (itself resumed) solve's ring: a scan that
    wrote into its checkpoint would corrupt the next resume."""
    inp = _fleet()
    t = _Trio()
    t.solve(inp, "base")
    cur = inp
    for n, k in enumerate((N_SPECS - 5, N_SPECS - 11, N_SPECS - 17)):
        cur = _add_replica(cur, k, f"chain-{n}")  # run index N_SPECS-1-k: 4, 10, 16
        t.solve(cur, f"chain-{n}")
        assert t.warm.stats["resume_solves"] == n + 1, t.warm.stats
    assert t.warm.stats["resume_runs_skipped"] == t.tpu.stats["resume_runs_skipped"] > 12



def test_resume_through_the_wide_refetch(monkeypatch):
    """A delta capacity too small for the solve's entries forces the wide
    re-fetch: a resumed solve then stitches dense rows (the donor's first k,
    then the suffix's), as in the JAX backend."""
    from karpenter_tpu_torch.solver import backend as tbackend

    monkeypatch.setattr(jbackend, "delta_capacity", lambda *a: 4)
    monkeypatch.setattr(tbackend, "delta_capacity", lambda *a: 4)
    inp = _fleet()
    t = _Trio()
    t.solve(inp, "base")
    t.solve(_add_replica(inp, N_SPECS - 5, "mid-0"), "mid-insert")  # run 4: k = 4
    assert t.warm.stats["resume_solves"] == 1 and t.warm.stats["wide_refetches"] == 2
