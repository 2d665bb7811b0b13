# Port copy of karpenter_tpu/solver/pipeline.py (the metric gauges
# SOLVE_PIPELINE_DEPTH / SOLVE_COALESCED / SOLVE_PIPELINE_OCCUPANCY, the
# telemetry sampler obstelemetry.maybe_sample, the trace spans and per-member
# traces, and slo_stats left out: their counts stay in `stats`).
"""Pipelined solve service: the single owner of the device solve seam.

Every `Solver.solve()` in the control plane is a blocking round-trip: host
encode, device compute, link transfer, host decode, serialized per caller.
The `AsyncSolve` seam (backend.py) already splits dispatch from decode;
`SolveService` turns it into a three-stage pipeline:

        dispatcher thread            device / link           decoder thread
    ┌──────────────────────┐   ┌─────────────────────┐   ┌─────────────────┐
    │ encode + dispatch N+1│ ∥ │ compute + d2h  N    │ ∥ │ decode      N−1 │
    └──────────────────────┘   └─────────────────────┘   └─────────────────┘

Controllers submit() and block on a `SolveTicket`; the service serializes
device ownership through one dispatcher thread, so concurrent submitters
never race the arena or the encode cache.

Coalescing: provisioning-class requests are whole-cluster snapshots, so a
new provisioning request supersedes every provisioning request of the same
tenant still QUEUED (not yet dispatched): the stale snapshot never runs and
its ticket raises `Superseded`. Requests already dispatched are never
cancelled.

Fairness: the dispatcher alternates between the provisioning and
disruption classes, so neither starves the other.

Fused cohorts: `submit_cohort` queues several tenants' requests as ONE
unit that dispatches through the backend's `solve_cohort_async` (one
lane-batched launch) and resolves each member's ticket on its own.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

PROVISIONING = "provisioning"
DISRUPTION = "disruption"


class Superseded(Exception):
    """The request coalesced away: a newer cluster-state revision was
    submitted before this one dispatched. The newer request's solve covers
    the cluster; the caller must NOT act on this stale snapshot (the
    superseding ticket is available as `.by`)."""

    def __init__(self, by: Optional["SolveTicket"] = None):
        super().__init__("solve request superseded by a newer cluster snapshot")
        self.by = by


class ServiceStopped(Exception):
    """The service was stopped before this request could run (terminal:
    the ticket resolves with this error rather than stranding a waiter)."""


class SolveTicket:
    """Caller-side handle for a submitted request. result() blocks until the
    decode stage delivers (or re-raises the request's failure).

    Delivery is first-wins: once resolved, later deliveries are ignored, so
    a force-resolve racing a late decode can never overwrite a real result."""

    def __init__(self, kind: str, rev=None, tenant_id: Optional[str] = None):
        self.kind = kind
        self.rev = rev
        # scopes provisioning coalescing: only same-tenant snapshots
        # supersede each other (None = single-tenant)
        self.tenant_id = tenant_id
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self._callbacks = []

    def _deliver(self, result=None, error: Optional[BaseException] = None) -> bool:
        """Resolve the ticket. Returns True if THIS call delivered, False if
        the ticket was already resolved (the late delivery is dropped)."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._error = error
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — observer must not break delivery
                pass
        return True

    def on_done(self, cb: Callable[["SolveTicket"], None]) -> None:
        """Invoke cb(ticket) at delivery (immediately if already resolved)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def superseded(self) -> bool:
        return isinstance(self._error, Superseded)

    def error(self) -> Optional[BaseException]:
        """The resolution error, if any (None while unresolved / on success)."""
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("solve ticket not resolved in time")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("ticket", "inp", "fn", "rev", "cohort")

    def __init__(self, ticket: Optional[SolveTicket], inp=None, fn=None, rev=None,
                 cohort=None):
        self.ticket = ticket
        self.inp = inp
        self.fn = fn  # generic device work: fn() dispatches, returns finish()
        self.rev = rev
        # fused cohort unit (submit_cohort): the member _Requests that
        # dispatch as ONE device launch; the unit itself has ticket=None and
        # its members' tickets resolve individually at decode
        self.cohort = cohort


class SolveService:
    """Owns the device: all solve dispatches in the process serialize
    through this service's dispatcher thread (construction starts the
    worker threads; they are daemons and idle at zero cost)."""

    def __init__(self, solver, depth: int = 2, clock=time.monotonic):
        self.solver = solver
        self.depth = max(1, int(depth))
        self.clock = clock
        self._cv = threading.Condition()
        self._pending: Dict[str, deque] = {PROVISIONING: deque(), DISRUPTION: deque()}
        self._inflight: deque = deque()  # (_Request, finish_fn)
        self._active: set = set()  # tickets popped from pending, unresolved
        self._last_kind = DISRUPTION  # provisioning gets the first slot
        self._stopped = False
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "dispatched": 0,
            "completed": 0,
            "failed": 0,
            "coalesced": 0,
        }
        # occupancy: wall-time fraction with >=1 request in flight since
        # construction (1.0: the device never idled between solves)
        self._started_at = clock()
        self._busy_since: Optional[float] = None
        self._busy_s = 0.0
        self._decoding = 0  # requests popped from _inflight, still in finish()
        self._dispatching = 0  # requests popped from _pending, not yet in flight
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="solve-dispatch"
        )
        self._decoder = threading.Thread(
            target=self._decode_loop, daemon=True, name="solve-decode"
        )
        self._dispatcher.start()
        self._decoder.start()

    # -- submission ----------------------------------------------------------

    def submit(self, inp, kind: str = PROVISIONING, rev=None,
               tenant_id: Optional[str] = None) -> SolveTicket:
        """Queue a SolverInput. Provisioning-class submits coalesce: every
        provisioning request of the same tenant still queued is superseded
        (its ticket raises Superseded). `rev` is the snapshot's revision
        stamp (SolverInput.state_rev), recorded for observability."""
        if rev is None:
            rev = getattr(inp, "state_rev", None)
        if tenant_id is None:
            tenant_id = getattr(inp, "tenant_id", None)
        ticket = SolveTicket(kind, rev=rev, tenant_id=tenant_id)
        with self._cv:
            if self._stopped:
                raise ServiceStopped("solve service is closed")
            if kind == PROVISIONING:
                self._coalesce_locked(tenant_id, ticket)
            self._pending[kind].append(_Request(ticket, inp=inp, rev=rev))
            self.stats["submitted"] += 1
            self._cv.notify_all()
        return ticket

    def submit_fn(self, dispatch_fn: Callable, kind: str = DISRUPTION,
                  tenant_id: Optional[str] = None) -> SolveTicket:
        """Queue generic device work: dispatch_fn() runs on the dispatcher
        thread (host prep + device dispatch) and returns a finish callable;
        finish() runs on the decoder thread and its return value resolves
        the ticket. Never coalesced."""
        ticket = SolveTicket(kind, tenant_id=tenant_id)
        with self._cv:
            if self._stopped:
                raise ServiceStopped("solve service is closed")
            self._pending[kind].append(_Request(ticket, fn=dispatch_fn))
            self.stats["submitted"] += 1
            self._cv.notify_all()
        return ticket

    def submit_cohort(self, members) -> list:
        """Queue a fused cohort: ONE device dispatch serves every member
        (the backend's solve_cohort_async fuses the launch). Each member
        dict carries inp and optionally kind / rev / tenant_id; one
        SolveTicket per member is returned, in order, and each resolves
        individually at decode. Same-tenant provisioning coalescing applies
        per member, including members of cohort units still queued."""
        if not members:
            return []
        tickets: list = []
        with self._cv:
            if self._stopped:
                raise ServiceStopped("solve service is closed")
            reqs: list = []
            for m in members:
                inp = m["inp"]
                kind = m.get("kind", PROVISIONING)
                rev = m.get("rev")
                if rev is None:
                    rev = getattr(inp, "state_rev", None)
                tenant_id = m.get("tenant_id")
                if tenant_id is None:
                    tenant_id = getattr(inp, "tenant_id", None)
                ticket = SolveTicket(kind, rev=rev, tenant_id=tenant_id)
                if kind == PROVISIONING:
                    self._coalesce_locked(tenant_id, ticket)
                reqs.append(_Request(ticket, inp=inp, rev=rev))
                self.stats["submitted"] += 1
                tickets.append(ticket)
            self._pending[reqs[0].ticket.kind].append(_Request(None, cohort=reqs))
            self._cv.notify_all()
        return tickets

    def _supersede_locked(self, stale: _Request, ticket: SolveTicket) -> None:
        self.stats["coalesced"] += 1
        stale.ticket._deliver(error=Superseded(by=ticket))

    def _coalesce_locked(self, tenant_id, ticket: SolveTicket) -> None:
        """Supersede every provisioning request still queued for this
        tenant: plain requests AND members inside queued cohort units (a
        unit emptied of all its members is dropped from the queue whole)."""
        q = self._pending[PROVISIONING]
        keep: deque = deque()
        while q:
            stale = q.popleft()
            if stale.cohort is not None:
                live = []
                for m in stale.cohort:
                    if m.ticket.tenant_id != tenant_id:
                        live.append(m)
                        continue
                    self._supersede_locked(m, ticket)
                stale.cohort = live
                if live:
                    keep.append(stale)
                continue
            if stale.ticket.tenant_id != tenant_id:
                keep.append(stale)
                continue
            self._supersede_locked(stale, ticket)
        q.extend(keep)

    # -- introspection -------------------------------------------------------

    def occupancy(self) -> float:
        with self._cv:
            return self._occupancy_locked()

    def queue_depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._pending.values())

    def resume_stats(self) -> Dict[str, float]:
        """Checkpoint-resume counters of the owned backend (zeros when the
        backend has none)."""
        inner = self.solver
        stats = getattr(inner, "stats", None) or {}
        return {
            "resume_solves": int(stats.get("resume_solves", 0)),
            "resume_runs_skipped": int(stats.get("resume_runs_skipped", 0)),
            "resume_hit_rate": float(getattr(inner, "resume_hit_rate", 0.0)),
        }

    def shard_stats(self) -> Dict[str, float]:
        """Mesh-sharded solve counters of the owned backend. The port runs
        every solve on one card (multi-GPU is ROADMAP B14): no mesh, the
        counters its backend keeps (zeros), and every uploaded byte lands on
        that one device (the JAX ledger's per-device figure at n = 1)."""
        stats = getattr(self.solver, "stats", None) or {}
        ledger = getattr(self.solver, "ledger", None)
        return {
            "mesh_devices": 0,
            "sharded_solves": int(stats.get("sharded_solves", 0)),
            "shard_fixup_runs": int(stats.get("shard_fixup_runs", 0)),
            "sharded_fallbacks": int(stats.get("sharded_fallbacks", 0)),
            "shard_resume_solves": int(stats.get("shard_resume_solves", 0)),
            "shard_resume_runs_skipped": int(stats.get("shard_resume_runs_skipped", 0)),
            "shard_upload_bytes_per_device": float(
                getattr(ledger, "upload_bytes_per_solve", 0.0) or 0.0),
        }

    def decode_stats(self) -> Dict[str, float]:
        """On-device decode + relax-ladder counters of the owned backend
        (zeros when the backend has none)."""
        inner = self.solver
        stats = getattr(inner, "stats", None) or {}
        ledger = getattr(inner, "ledger", None)
        return {
            "decode_bytes_per_solve": float(
                getattr(ledger, "decode_bytes_per_solve", 0.0) or 0.0
            ),
            "relax_dispatches_per_solve": float(stats.get("relax_dispatches", 0)),
            "ladder_rungs_used": int(stats.get("ladder_rungs_used", 0)),
            "wide_refetches": int(stats.get("wide_refetches", 0)),
        }

    def streaming_stats(self) -> Dict[str, float]:
        """Streaming event-stage counters of the owned backend (zeros when
        the backend has none, or stream_run_events is off): hits are solves
        whose run tables reached the device as an edit-triplet scatter
        (arena.apply_run_events), misses declined and paid adopt's normal
        upload."""
        inner = self.solver
        stats = getattr(inner, "stats", None) or {}
        arena = getattr(inner, "arena", None)
        astats = getattr(arena, "stats", None) or {}
        return {
            "event_stage_hits": int(stats.get("event_stage_hits", 0)),
            "event_stage_misses": int(stats.get("event_stage_misses", 0)),
            "event_batches": int(astats.get("event_batches", 0)),
            "event_edits": int(astats.get("event_edits", 0)),
        }

    def close(self) -> None:
        """Stop accepting work; fail queued (undispatched) requests with
        ServiceStopped; let in-flight requests drain (up to 30s)."""
        self.stop(drain_s=30.0)

    def stop(self, drain_s: float = 30.0) -> None:
        """Terminal stop: no ticket issued by this service is ever left
        unresolved. Queued requests fail with ServiceStopped at once;
        in-flight requests get `drain_s` seconds to deliver their real
        result; anything still unresolved after that (a wedged dispatch or
        decode) is force-resolved with ServiceStopped. First-wins delivery
        makes the force-resolve safe against a late decode racing it."""
        with self._cv:
            self._stopped = True
            for q in self._pending.values():
                while q:
                    req = q.popleft()
                    for m in (req.cohort if req.cohort is not None else (req,)):
                        if m.ticket._deliver(error=ServiceStopped(
                            "solve service stopped before this request dispatched"
                        )):
                            self.stats["failed"] += 1
            self._cv.notify_all()
        for t in (self._dispatcher, self._decoder):
            t.join(timeout=drain_s)
        with self._cv:
            stranded = [tk for tk in self._active if not tk.done()]
            self._active.clear()
        for tk in stranded:
            if tk._deliver(error=ServiceStopped(
                "solve service stopped while this request was in flight"
            )):
                with self._cv:
                    self.stats["failed"] += 1

    # -- pipeline stages -----------------------------------------------------

    def _next_request_locked(self) -> Optional[_Request]:
        order = (
            (DISRUPTION, PROVISIONING)
            if self._last_kind == PROVISIONING
            else (PROVISIONING, DISRUPTION)
        )
        for kind in order:
            if self._pending[kind]:
                self._last_kind = kind
                return self._pending[kind].popleft()
        return None

    def _mark_busy_locked(self) -> None:
        if self._busy_since is None:
            self._busy_since = self.clock()

    def _mark_idle_locked(self) -> None:
        if self._busy_since is not None and not self._inflight and not self._decoding:
            self._busy_s += self.clock() - self._busy_since
            self._busy_since = None

    def _occupancy_locked(self) -> float:
        busy = self._busy_s
        if self._busy_since is not None:
            busy += self.clock() - self._busy_since
        wall = self.clock() - self._started_at
        return (busy / wall) if wall > 0 else 0.0

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (
                    len(self._inflight) >= self.depth
                    or self._next_peek_locked() is None
                ):
                    self._cv.wait()
                if self._stopped and self._next_peek_locked() is None:
                    return
                req = self._next_request_locked()
                self._dispatching += 1
                for m in (req.cohort if req.cohort is not None else (req,)):
                    self._active.add(m.ticket)
            # encode + dispatch OUTSIDE the lock: the stage-1 host work that
            # overlaps stage-2 device compute and stage-3 decode
            try:
                if req.cohort is not None:
                    finish = self._dispatch_cohort(req)
                elif req.fn is not None:
                    finish = req.fn()
                else:
                    solve_async = getattr(self.solver, "solve_async", None)
                    if solve_async is not None:
                        finish = solve_async(req.inp).result
                    else:
                        # backend without an async seam: the whole solve
                        # runs at decode, stage overlap degrades to FIFO
                        finish = lambda _inp=req.inp: self.solver.solve(_inp)  # noqa: E731
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                members = req.cohort if req.cohort is not None else (req,)
                with self._cv:
                    self.stats["failed"] += len(members)
                    self._dispatching -= 1
                    for m in members:
                        self._active.discard(m.ticket)
                    self._cv.notify_all()
                for m in members:
                    m.ticket._deliver(error=e)
                continue
            with self._cv:
                self.stats["dispatched"] += 1
                self._dispatching -= 1
                self._inflight.append((req, finish))
                self._mark_busy_locked()
                self._cv.notify_all()

    def _dispatch_cohort(self, unit: _Request):
        """Stage 1 for a fused unit: one solve_cohort_async call covers
        every member; the returned finish() yields member-aligned outcomes
        (result or exception). A backend without the cohort seam degrades to
        per-member solo dispatches that share this one pipeline slot:
        correctness is the same, only the fusion is lost."""
        members = unit.cohort
        sc = getattr(self.solver, "solve_cohort_async", None)
        if sc is not None:
            return sc([m.inp for m in members])
        handles: list = []
        solve_async = getattr(self.solver, "solve_async", None)
        for m in members:
            try:
                if solve_async is not None:
                    handles.append(solve_async(m.inp).result)
                else:
                    handles.append(lambda _inp=m.inp: self.solver.solve(_inp))
            except Exception as e:  # noqa: BLE001 — per-member outcome
                handles.append(e)

        def finish():
            out: list = []
            for h in handles:
                if isinstance(h, BaseException):
                    out.append(h)
                    continue
                try:
                    out.append(h())
                except Exception as e:  # noqa: BLE001 — per-member outcome
                    out.append(e)
            return out

        return finish

    def _next_peek_locked(self) -> Optional[str]:
        for kind in (PROVISIONING, DISRUPTION):
            if self._pending[kind]:
                return kind
        return None

    def _decode_loop(self) -> None:
        while True:
            with self._cv:
                while not self._inflight and not (
                    self._stopped
                    and not self._dispatching
                    and self._next_peek_locked() is None
                ):
                    self._cv.wait()
                if not self._inflight:
                    return  # stopped, nothing left to drain
                req, finish = self._inflight.popleft()
                self._decoding += 1
                self._cv.notify_all()  # a dispatch slot just freed
            if req.cohort is not None:
                self._decode_cohort(req, finish)
                continue
            try:
                result = finish()
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                with self._cv:
                    self.stats["failed"] += 1
                req.ticket._deliver(error=e)
            else:
                with self._cv:
                    self.stats["completed"] += 1
                req.ticket._deliver(result=result)
            with self._cv:
                self._decoding -= 1
                self._active.discard(req.ticket)
                self._mark_idle_locked()
                self._cv.notify_all()

    def _decode_cohort(self, req: _Request, finish) -> None:
        """Stage 3 for a fused unit: finish() returns member-aligned
        outcomes; each member's ticket resolves individually (a member's
        failure never taints its co-members' results)."""
        members = req.cohort
        try:
            outcomes = finish()
        except BaseException as e:  # noqa: BLE001 — delivered to callers
            outcomes = [e] * len(members)
        if not isinstance(outcomes, (list, tuple)) or len(outcomes) != len(members):
            err = RuntimeError("cohort finish returned misaligned outcomes")
            outcomes = [err] * len(members)
        for m, oc in zip(members, outcomes):
            if isinstance(oc, BaseException):
                with self._cv:
                    self.stats["failed"] += 1
                m.ticket._deliver(error=oc)
            else:
                with self._cv:
                    self.stats["completed"] += 1
                m.ticket._deliver(result=oc)
        with self._cv:
            self._decoding -= 1
            for m in members:
                self._active.discard(m.ticket)
            self._mark_idle_locked()
            self._cv.notify_all()
