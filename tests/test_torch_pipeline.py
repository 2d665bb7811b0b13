"""The port's serving pipeline (solver/pipeline.py SolveService) against the
JAX package's, on tests/test_solve_pipeline.py's scenarios.

Each mechanics scenario runs on both packages' SolveService with the JAX
tests' own stand-in solvers (a gated async seam, a sync-only backend, a
backend whose dispatch raises): results equal a direct solve, a newer
provisioning snapshot supersedes every queued one and the stale input never
reaches the solver, the dispatcher alternates provisioning and disruption,
close() fails queued work and drains work in flight, stop() resolves every
ticket even past a wedged dispatch. Then the port's service over
`TorchSolver(device="cpu")` against the JAX service over `TPUSolver()`:
direct-solve parity, `submit_cohort` resolving each member's ticket on its
own (one fused dispatch; a member the port refuses fails alone), coalescing
into a queued cohort, and the stats readers. The resilient-ladder scenario
waits for the port's resilient layer (ROADMAP A7).

Every wait has a timeout and every service is closed in `finally`, so a
hung thread fails one test instead of stalling the suite.
"""

import dataclasses
import threading

import pytest
import torch

from karpenter_tpu.solver import backend as jbackend
from karpenter_tpu.solver import pipeline as jpipe
from karpenter_tpu_torch.solver import pipeline as tpipe
from karpenter_tpu_torch.solver.backend import TorchSolver, UnsupportedInput
from tests.test_solve_pipeline import GatedAsyncSolver, SyncOnlySolver, mkinput
from tests.test_torch_cohort import _custom_key_member, _members
from tests.test_torch_relax import to_port
from tests.test_torch_solver import as_data

torch.set_num_threads(1)

WAIT = 30  # seconds any ticket or gate may take


@pytest.fixture(params=["jax", "torch"])
def pipe(request):
    return jpipe if request.param == "jax" else tpipe


# ---------------------------------------------------------------- mechanics


def test_constants_and_errors_pinned():
    assert (tpipe.PROVISIONING, tpipe.DISRUPTION) == (jpipe.PROVISIONING, jpipe.DISRUPTION)
    assert issubclass(tpipe.Superseded, Exception) and issubclass(tpipe.ServiceStopped, Exception)
    t = tpipe.SolveTicket(tpipe.PROVISIONING, rev=3, tenant_id="a")
    assert t._deliver(result=1) and not t._deliver(result=2)
    assert t.result(timeout=1) == 1 and t.done() and t.error() is None


def test_sync_only_backend_degrades_to_fifo(pipe):
    solver = SyncOnlySolver()
    svc = pipe.SolveService(solver, depth=2)
    try:
        tickets = [svc.submit(mkinput(f"s{i}"), kind=pipe.DISRUPTION) for i in range(3)]
        assert [t.result(timeout=WAIT) for t in tickets] == [
            ("sync", "s0"), ("sync", "s1"), ("sync", "s2")]
        assert [inp.pods[0].meta.name for inp in solver.solved] == ["s0", "s1", "s2"]
    finally:
        svc.close()


def test_coalescing_supersedes_every_queued_provisioning_request(pipe):
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=2)
    try:
        t1 = svc.submit(mkinput("p1"), kind=pipe.PROVISIONING, rev=("r", 1))
        assert solver.dispatching.wait(WAIT)  # p1 popped: no longer coalescible
        t2 = svc.submit(mkinput("p2"), kind=pipe.PROVISIONING, rev=("r", 2))
        t3 = svc.submit(mkinput("p3"), kind=pipe.PROVISIONING, rev=("r", 3))
        assert t2.done() and t2.superseded()
        with pytest.raises(pipe.Superseded) as ei:
            t2.result(timeout=WAIT)
        assert ei.value.by is t3
        solver.gate.set()
        assert t1.result(timeout=WAIT) == ("ok", "p1")
        assert t3.result(timeout=WAIT) == ("ok", "p3")
        assert solver.order == ["p1", "p3"]  # the stale snapshot never ran
        assert svc.stats["coalesced"] == 1 and svc.stats["completed"] == 2
    finally:
        solver.gate.set()
        svc.close()


def test_coalescing_is_per_tenant(pipe):
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=1)
    try:
        t0 = svc.submit(mkinput("x0"), kind=pipe.PROVISIONING, tenant_id="a")
        assert solver.dispatching.wait(WAIT)
        ta = svc.submit(mkinput("a1"), kind=pipe.PROVISIONING, tenant_id="a")
        tb = svc.submit(mkinput("b1"), kind=pipe.PROVISIONING, tenant_id="b")
        ta2 = svc.submit(mkinput("a2"), kind=pipe.PROVISIONING, tenant_id="a")
        assert ta.superseded() and not tb.done()
        solver.gate.set()
        for t in (t0, tb, ta2):
            t.result(timeout=WAIT)
        assert solver.order == ["x0", "b1", "a2"]
    finally:
        solver.gate.set()
        svc.close()


def test_fair_interleave_between_classes(pipe):
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=1)
    try:
        t1 = svc.submit(mkinput("p1"), kind=pipe.PROVISIONING)
        assert solver.dispatching.wait(WAIT)
        td = svc.submit_fn(
            lambda: (solver.order.append("d1"), (lambda: ("ok", "d1")))[1],
            kind=pipe.DISRUPTION,
        )
        t2 = svc.submit(mkinput("p2"), kind=pipe.PROVISIONING)
        assert svc.queue_depth() == 2
        solver.gate.set()
        for t in (t1, td, t2):
            t.result(timeout=WAIT)
        # after a provisioning dispatch the disruption class gets the slot
        assert solver.order == ["p1", "d1", "p2"]
    finally:
        solver.gate.set()
        svc.close()


def test_submit_fn_resolves_with_finish_value(pipe):
    svc = pipe.SolveService(SyncOnlySolver(), depth=1)
    try:
        t = svc.submit_fn(lambda: (lambda: {"verdicts": [1, 2, 3]}), kind=pipe.DISRUPTION)
        assert t.result(timeout=WAIT) == {"verdicts": [1, 2, 3]}
    finally:
        svc.close()


def test_close_fails_queued_and_drains_inflight(pipe):
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=1)
    closer = threading.Thread(target=svc.close, daemon=True)
    try:
        t1 = svc.submit(mkinput("p1"), kind=pipe.PROVISIONING)
        assert solver.dispatching.wait(WAIT)
        t2 = svc.submit(mkinput("p2"), kind=pipe.PROVISIONING)
        closer.start()
        with pytest.raises(pipe.ServiceStopped):  # queued p2 fails fast
            t2.result(timeout=WAIT)
        solver.gate.set()
        closer.join(timeout=WAIT)
        assert not closer.is_alive()
        assert t1.result(timeout=WAIT) == ("ok", "p1")  # in-flight work drained
        with pytest.raises(pipe.ServiceStopped):
            svc.submit(mkinput("p3"))
        with pytest.raises(pipe.ServiceStopped):
            svc.submit_cohort([{"inp": mkinput("p4")}])
        assert 0.0 <= svc.occupancy() <= 1.0
    finally:
        solver.gate.set()
        svc.stop(drain_s=WAIT)


def test_dispatch_error_delivers_to_caller(pipe):
    class Boom:
        def solve_async(self, inp):
            raise RuntimeError("encode exploded")

    svc = pipe.SolveService(Boom(), depth=2)
    try:
        t = svc.submit(mkinput("x"), kind=pipe.DISRUPTION)
        with pytest.raises(RuntimeError, match="encode exploded"):
            t.result(timeout=WAIT)
        assert svc.stats["failed"] == 1
    finally:
        svc.close()


def test_stop_resolves_every_ticket_even_with_wedged_dispatch(pipe):
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=1)
    try:
        t1 = svc.submit(mkinput("w1"), kind=pipe.DISRUPTION)
        assert solver.dispatching.wait(WAIT)
        t2 = svc.submit(mkinput("w2"), kind=pipe.DISRUPTION)
        t3 = svc.submit(mkinput("w3"), kind=pipe.PROVISIONING)
        svc.stop(drain_s=0.1)  # the wedge holds: drain expires, force-resolve
        for t in (t1, t2, t3):
            with pytest.raises(pipe.ServiceStopped):
                t.result(timeout=5)
        assert svc.stats["failed"] >= 3
        err_before = t1.error()
    finally:
        solver.gate.set()
    # the wedged dispatch returns on the abandoned daemon thread; its late
    # delivery loses first-wins
    assert t1.error() is err_before


def test_cohort_unit_without_the_cohort_seam(pipe):
    """A backend without solve_cohort_async serves a cohort unit as solo
    dispatches sharing one pipeline slot; every ticket resolves."""
    solver = SyncOnlySolver()
    svc = pipe.SolveService(solver, depth=1)
    try:
        tickets = svc.submit_cohort([{"inp": mkinput(f"c{i}"), "kind": pipe.DISRUPTION}
                                     for i in range(3)])
        assert [t.result(timeout=WAIT) for t in tickets] == [("sync", f"c{i}") for i in range(3)]
        assert svc.stats["dispatched"] == 1 and svc.stats["completed"] == 3
        assert svc.submit_cohort([]) == []
    finally:
        svc.close()


def test_cohort_member_coalesces_while_queued(pipe):
    """A newer provisioning snapshot of a tenant supersedes that tenant's
    member inside a queued cohort unit; the unit keeps its other members."""
    solver = GatedAsyncSolver()
    svc = pipe.SolveService(solver, depth=1)
    try:
        t0 = svc.submit(mkinput("hold"), kind=pipe.DISRUPTION)
        assert solver.dispatching.wait(WAIT)
        ta, tb = svc.submit_cohort([{"inp": mkinput("ca"), "tenant_id": "a"},
                                    {"inp": mkinput("cb"), "tenant_id": "b"}])
        ta2 = svc.submit(mkinput("ca2"), kind=pipe.PROVISIONING, tenant_id="a")
        assert ta.superseded() and ta.error().by is ta2
        solver.gate.set()
        assert tb.result(timeout=WAIT) == ("ok", "cb")
        assert ta2.result(timeout=WAIT) == ("ok", "ca2")
        t0.result(timeout=WAIT)
        assert "ca" not in solver.order
    finally:
        solver.gate.set()
        svc.close()


def test_ledger_records_from_many_threads():
    """The serving pipeline records uploads on its dispatcher thread and
    fetches on its decoder thread into one TransferLedger: updates from
    more threads than cores, switching every microsecond, lose nothing."""
    import sys

    from karpenter_tpu_torch.solver.arena import TransferLedger

    led = TransferLedger()
    n_threads, n_records = 16, 2000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_records):
                led.record_upload(3, 1, msgs=1)
                led.record_fetch(5, msgs=1)
                led.record_adopt("exact_hit" if k % 2 else "delta_upload")

        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    n = n_threads * n_records
    assert led.total == {"h2d_bytes": 3 * n, "h2d_arrays": n, "h2d_msgs": n,
                         "d2h_bytes": 5 * n, "d2h_msgs": n}
    assert led.outcomes == {"exact_hit": n // 2, "delta_upload": n // 2, "full_upload": 0}


# ---------------------------------------------------- over the real backends


def test_results_equal_direct_solves():
    inps = [mkinput(f"d{i}", cpu=("250m", "500m", "2")[i % 3]) for i in range(4)]
    direct = [TorchSolver(device="cpu").solve(to_port(x)) for x in inps]
    jsvc = jpipe.SolveService(jbackend.TPUSolver(), depth=2)
    tsvc = tpipe.SolveService(TorchSolver(device="cpu"), depth=2)
    try:
        jt = [jsvc.submit(x, kind=jpipe.DISRUPTION) for x in inps]
        tt = [tsvc.submit(to_port(x), kind=tpipe.DISRUPTION) for x in inps]
        for d, j, t in zip(direct, jt, tt):
            got = as_data(t.result(timeout=120))
            assert got == as_data(d) == as_data(j.result(timeout=120))
        assert tsvc.stats["completed"] == 4 and tsvc.stats["failed"] == 0
        assert tsvc.resume_stats() == jsvc.resume_stats()
        assert tsvc.decode_stats()["wide_refetches"] == jsvc.decode_stats()["wide_refetches"]
        assert tsvc.shard_stats() == jsvc.shard_stats()
    finally:
        jsvc.close()
        tsvc.close()


def test_submit_cohort_resolves_each_ticket():
    """Four tenants' members and one the port refuses (a custom-key
    spread) in one unit: the four fuse into one dispatch on both backends
    and resolve as the JAX service's; the refused member's ticket alone
    raises UnsupportedInput (the reference's falls back)."""
    members = _members(4, 77, "svc") + [_custom_key_member("svc-rack")]
    jsolver, tsolver = jbackend.TPUSolver(), TorchSolver(device="cpu")
    jsvc = jpipe.SolveService(jsolver, depth=2)
    tsvc = tpipe.SolveService(tsolver, depth=2)
    try:
        jt = jsvc.submit_cohort([{"inp": m, "kind": jpipe.DISRUPTION} for m in members])
        tt = tsvc.submit_cohort([{"inp": to_port(m), "kind": tpipe.DISRUPTION} for m in members])
        assert [t.tenant_id for t in tt] == [m.tenant_id for m in members]
        for i in range(4):
            assert as_data(tt[i].result(timeout=120)) == as_data(jt[i].result(timeout=120)), i
        with pytest.raises(UnsupportedInput):
            tt[4].result(timeout=120)
        jt[4].result(timeout=120)
        assert tsolver.stats["fused_dispatches"] == jsolver.stats["fused_dispatches"] == 1
        assert tsolver.stats["fused_members"] == 4
        assert tsvc.stats["dispatched"] == 1
        assert tsvc.stats["completed"] == 4 and tsvc.stats["failed"] == 1
    finally:
        jsvc.close()
        tsvc.close()


def test_streaming_stats_through_the_service():
    """stream_run_events on the owned backend: the service's streaming
    reader reports the stage as the JAX service's does."""
    base = mkinput("s0")
    grown = dataclasses.replace(base, pods=base.pods + mkinput("s1").pods)
    jsolver, tsolver = jbackend.TPUSolver(), TorchSolver(device="cpu")
    jsolver.stream_run_events = tsolver.stream_run_events = True
    jsvc = jpipe.SolveService(jsolver, depth=1)
    tsvc = tpipe.SolveService(tsolver, depth=1)
    try:
        for inp in (base, grown, base):
            j = jsvc.submit(inp, kind=jpipe.DISRUPTION).result(timeout=120)
            t = tsvc.submit(to_port(inp), kind=tpipe.DISRUPTION).result(timeout=120)
            assert as_data(t) == as_data(j)
        assert tsvc.streaming_stats() == jsvc.streaming_stats()
        assert tsvc.streaming_stats()["event_stage_misses"] >= 1
    finally:
        jsvc.close()
        tsvc.close()
