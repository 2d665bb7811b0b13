"""Virtual multi-process host mesh: worker processes for the run-axis solve
(the port of karpenter_tpu/parallel/hostmesh.py, PERF row 17h).

A multi-node deployment runs one process per node; this module is the
stand-in that keeps that layout runnable on one machine. Each worker is a
REAL separate process (a fresh interpreter, its own memory and its own CUDA
context) speaking a length-prefixed pickle protocol over its stdin/stdout
pipes. Jobs:

- ``ffd_blocks``: the mesh-solve leg. The worker scans its contiguous slice
  of the run blocks through K17 (``ffd_solve_sharded``; K17s,
  ``ffd_solve_sharded_sparse``, when the job carries the index tables) on
  its device and returns the lane outputs as numpy arrays; the parent
  stitches the blocks exactly as for an in-process mesh
  (backend._shard_stitch).
- ``ping``: the worker's pid, device, kernel launch counts (set to 0 again
  when the job says ``reset``), the top-level
  packages it has loaded and its last timed job (an ``ffd_blocks`` job with
  ``time_calls`` holds the kernel against its plain version and times it).
- ``solve``: the reference's federation leg holds a ReferenceSolver, which
  the port does not have yet: the worker answers it with an error (ROADMAP
  A3).

The broadcast tables of an ``ffd_blocks`` job are uploaded to the worker's
device once per caller-chosen ``ctx`` token and kept resident there (the
pipe analog of the argument arena's residency): repeat dispatches against
the same context ship only the run blocks.

The reference pins its workers to the CPU because its parent holds the TPU,
which processes do not share. CUDA cards are shared between processes, so
the port's worker i runs on ``cuda:(i % device_count)``, or on the CPU
(the plain versions) when the pool is built with ``device="cpu"``, as the
tests do. The device rides the worker's command line. A worker told to use
CUDA that finds none exits with an error; it never carries on on the CPU.
The parent builds the kernels before the workers start, so no two workers
run nvcc into the build directory at once. Each worker runs with
OMP_NUM_THREADS=1; its stdout is the protocol channel, so everything else
it prints goes to stderr.
"""

from __future__ import annotations

import argparse
import collections
import os
import pickle
import struct
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional

from .sharded import tree_concat as _tree_concat

_LEN = struct.Struct("<Q")
CTX_SLOTS = 16  # broadcast-table contexts a worker keeps resident (LRU)
_REPO_ROOT = Path(__file__).resolve().parents[2]


class WorkerDead(RuntimeError):
    """The worker process is gone (EOF or a broken pipe mid-call): the
    caller treats every outstanding job on this worker as failed; jobs are
    never retried here."""


def _write_frame(fh, obj) -> int:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    fh.write(_LEN.pack(len(blob)))
    fh.write(blob)
    fh.flush()
    return _LEN.size + len(blob)


def _read_exact(fh, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = fh.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(fh):
    head = _read_exact(fh, _LEN.size)
    if head is None:
        return None
    blob = _read_exact(fh, _LEN.unpack(head)[0])
    if blob is None:
        return None
    return pickle.loads(blob)


# -- worker side --------------------------------------------------------------


def _handle_ffd_blocks(job, ctx_cache: "collections.OrderedDict", device):
    """Scan this worker's [nb, Sblk] run blocks with K17 (K17s with the
    index tables) on `device`, the broadcast tables from the job or, when it
    carries none, from the tables resident under its ctx. Returns the lane
    outputs as an FFDOutput of numpy arrays with a leading [nb] axis."""
    import numpy as np
    import torch

    from ..solver.convert import array_to_torch, output_to_host
    from ..solver.cuda.ffd import (ffd_solve_sharded, ffd_solve_sharded_plain,
                                   ffd_solve_sharded_sparse)
    from .sharded import device_scope

    dev = torch.device(device)
    ctx = job.get("ctx")
    rest = job.get("rest")
    with device_scope(dev):
        if rest is not None:
            tables = tuple(array_to_torch(np.ascontiguousarray(a), dev) for a in rest)
            if ctx is not None:
                ctx_cache[ctx] = tables
                ctx_cache.move_to_end(ctx)
                while len(ctx_cache) > CTX_SLOTS:
                    ctx_cache.popitem(last=False)
        else:
            tables = ctx_cache[ctx]
            ctx_cache.move_to_end(ctx)

        def up(a):
            return array_to_torch(np.ascontiguousarray(a), dev)

        kw = dict(max_claims=int(job["max_claims"]), zone_engine=bool(job.get("zone_engine", False)))
        rg, rc = up(job["rg"]), up(job["rc"])
        sp = None if job.get("sq") is None else (up(job["sq"]), up(job["sv"]))

        def run():
            if sp is not None:
                return ffd_solve_sharded_sparse(*sp, rg, rc, *tables, **kw)
            return ffd_solve_sharded(rg, rc, *tables, **kw)

        host = output_to_host(run())
        n = int(job.get("time_calls") or 0)
        if n:
            _time_blocks(run, lambda: ffd_solve_sharded_plain(rg, rc, *tables, sparse=sp, **kw),
                         host, n, dev)
        return host


# the last timed ffd_blocks job of this worker (ping reports it)
WORKER_TIMING: dict = {}


def _time_blocks(run, plain, host, n: int, dev) -> None:
    """A timed job, beside the main path: the kernel's outputs against its
    plain version on the same device tensors (max |difference| over every
    leaf), then the kernel's time over n launches between CUDA events, and
    the plain version's once. On the CPU the lanes are the plain version's
    and `ms` is the host clock's (no device time). These launches count in
    LAUNCHES like any other: a caller reads the main path's counts before
    it asks for one."""
    import time

    import numpy as np
    import torch

    from ..solver.convert import output_to_host

    t0 = time.perf_counter()
    ref = output_to_host(plain())
    plain_ms = (time.perf_counter() - t0) * 1e3

    def leaves(o):
        return [o.take_e, o.take_c, o.leftover, o.events, *o.state]

    err = max(int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).max(initial=0))
              for a, b in zip(leaves(host), leaves(ref)))
    run()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / n
    WORKER_TIMING.clear()
    WORKER_TIMING.update(ms=ms, plain_ms=plain_ms, max_abs_err=err, calls=n,
                         lanes=int(host.take_e.shape[0]), device=str(dev))


def worker_main(stdin=None, stdout=None, device="cuda") -> int:
    """Job loop: read a frame, run it, answer {"ok": ..., ...}. The lanes run
    on `device`, the card unless the caller asks for the CPU; a CUDA device
    without a card raises before the loop."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"host-mesh worker: {device} requested but CUDA is not available "
                           "(pass device='cpu' for the plain versions)")
    inb = stdin if stdin is not None else sys.stdin.buffer
    outb = stdout if stdout is not None else sys.stdout.buffer
    ctx_cache: collections.OrderedDict = collections.OrderedDict()
    while True:
        job = _read_frame(inb)
        if job is None or job.get("kind") == "exit":
            return 0
        try:
            kind = job.get("kind")
            if kind == "ping":
                from ..solver.cuda import ffd

                result = {"pid": os.getpid(), "device": str(device),
                          "launches": {k: v for k, v in ffd.LAUNCHES.items() if v},
                          "packages": sorted({m.split(".")[0] for m in sys.modules}),
                          "timing": dict(WORKER_TIMING)}
                if job.get("reset"):  # the counts start again from 0
                    for k in ffd.LAUNCHES:
                        ffd.LAUNCHES[k] = 0
            elif kind == "ffd_blocks":
                result = _handle_ffd_blocks(job, ctx_cache, device)
            elif kind == "solve":
                raise RuntimeError("the solve job needs the oracle (ROADMAP A3)")
            else:
                raise ValueError(f"unknown job kind: {kind!r}")
            reply = {"ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 -- reply, don't die
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        _write_frame(outb, reply)


# -- parent side --------------------------------------------------------------


class WorkerProc:
    """One worker host: a subprocess on `device` behind a framed pickle
    pipe. Calls serialize per worker; a pool issues to all of its workers at
    once. `bytes_sent` / `bytes_received` count the frames both ways."""

    def __init__(self, name: str = "host", device: str = "cuda"):
        self.name = name
        self.device = str(device)
        wenv = os.environ.copy()
        wenv["OMP_NUM_THREADS"] = "1"
        wenv["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_REPO_ROOT), wenv.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.parallel.hostmesh", "--device",
             self.device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=wenv, cwd=str(_REPO_ROOT),
        )
        self._lock = threading.Lock()
        # the contexts this worker holds resident, in its LRU order
        self._ctx_seen: collections.OrderedDict = collections.OrderedDict()
        self.bytes_sent = 0
        self.bytes_received = 0

    def alive(self) -> bool:
        return self.proc.poll() is None

    def call(self, job: dict):
        """Round-trip one job; raises WorkerDead on a broken pipe or EOF (a
        killed or failed host), RuntimeError on a job-level failure."""
        blob = pickle.dumps(job, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            if not self.alive():
                raise WorkerDead(f"{self.name}: worker exited ({self.proc.returncode})")
            try:
                self.proc.stdin.write(_LEN.pack(len(blob)))
                self.proc.stdin.write(blob)
                self.proc.stdin.flush()
                self.bytes_sent += _LEN.size + len(blob)
                head = _read_exact(self.proc.stdout, _LEN.size)
                body = None if head is None else _read_exact(self.proc.stdout,
                                                             _LEN.unpack(head)[0])
            except (BrokenPipeError, OSError) as e:
                raise WorkerDead(f"{self.name}: {e}") from e
            if body is None:
                raise WorkerDead(f"{self.name}: EOF mid-call")
            self.bytes_received += _LEN.size + len(body)
        reply = pickle.loads(body)
        if not reply.get("ok"):
            raise RuntimeError(f"{self.name}: {reply.get('error')}")
        return reply.get("result")

    def note_ctx(self, ctx: str) -> None:
        """Record that the worker now holds `ctx` resident (its LRU order)."""
        self._ctx_seen[ctx] = True
        self._ctx_seen.move_to_end(ctx)
        while len(self._ctx_seen) > CTX_SLOTS:
            self._ctx_seen.popitem(last=False)

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass

    def close(self) -> None:
        if self.alive():
            try:
                with self._lock:
                    _write_frame(self.proc.stdin, {"kind": "exit"})
            except (BrokenPipeError, OSError):
                pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.kill()
            self.proc.wait(timeout=30)
        for fh in (self.proc.stdin, self.proc.stdout):
            try:
                fh.close()
            except OSError:
                pass


class HostMeshPool:
    """N worker hosts forming a virtual 1-D host mesh over the run axis.

    `device` None means "cuda": worker i runs on cuda:(i % device_count),
    and the pool raises when no card is visible; "cpu" runs every worker's
    lanes through the plain versions. `scatter_blocks` splits the [Nd, Sblk]
    block tables into contiguous per-host slices (the process-major layout
    of make_process_mesh), dispatches them at once and gathers the lane
    outputs back into one [Nd, ...] FFDOutput for the parent's stitch.
    Broadcast tables ride once per (host, ctx)."""

    def __init__(self, n_hosts: int = 2, device=None):
        import torch

        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("HostMeshPool: CUDA is not available (pass device='cpu' "
                                   "for the plain versions)")
            from ..solver.cuda.build import build

            build()  # once, here: the workers load what the parent built
            n_dev = torch.cuda.device_count()
            devices = [f"cuda:{i % n_dev}" if dev.index is None else str(dev)
                       for i in range(n_hosts)]
        else:
            devices = [str(dev)] * n_hosts
        self.workers: List[WorkerProc] = []
        try:
            for i, d in enumerate(devices):
                self.workers.append(WorkerProc(f"host{i}", device=d))
        except BaseException:
            self.close()
            raise

    @property
    def width(self) -> int:
        return len(self.workers)

    def ping_all(self, reset: bool = False) -> List[dict]:
        """Every worker's ping; `reset` also sets its launch counts to 0."""
        return [w.call({"kind": "ping", "reset": reset}) for w in self.workers]

    def pipe_bytes(self) -> tuple:
        """Frame bytes through every worker's pipes so far: (sent to the
        workers, received from them)."""
        return (sum(w.bytes_sent for w in self.workers),
                sum(w.bytes_received for w in self.workers))

    def scatter_blocks(self, rgb, rcb, rest: tuple, max_claims: int, ctx: Optional[str] = None,
                       zone_engine: bool = False, sqb=None, svb=None, time_calls: int = 0):
        """The lanes of every worker's blocks, gathered in block order.
        `time_calls` > 0 also has each worker on a card hold its kernel
        against the plain version and time it (WORKER_TIMING, read by
        ping_all), beside the main path."""
        import numpy as np

        rgb = np.asarray(rgb)
        rcb = np.asarray(rcb)
        Nd = int(rgb.shape[0])
        n = self.width
        if Nd % n:
            raise ValueError(f"{Nd} blocks do not divide across {n} hosts")
        per = Nd // n
        results: list = [None] * n
        errors: list = []

        def _dispatch(i: int) -> None:
            w = self.workers[i]
            send_rest = rest
            if ctx is not None and ctx in w._ctx_seen:
                send_rest = None
            sl = slice(i * per, (i + 1) * per)
            try:
                results[i] = w.call({
                    "kind": "ffd_blocks", "rg": rgb[sl], "rc": rcb[sl], "rest": send_rest,
                    "ctx": ctx, "max_claims": int(max_claims), "zone_engine": bool(zone_engine),
                    "sq": None if sqb is None else sqb[sl],
                    "sv": None if svb is None else svb[sl], "time_calls": int(time_calls),
                })
                if ctx is not None:
                    w.note_ctx(ctx)
            except BaseException as e:  # noqa: BLE001 -- gathered below
                errors.append((i, e))

        threads = [threading.Thread(target=_dispatch, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0][1]
        return _tree_concat(results)

    def close(self) -> None:
        for w in self.workers:
            w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """The worker process: the job loop on `--device` (the card by default;
    without CUDA it raises before touching its streams). Its stdout becomes
    the protocol channel alone (file descriptor 1 is pointed at stderr, so
    nothing else can write a byte into the frames)."""
    ap = argparse.ArgumentParser(description="a host-mesh worker (stdin/stdout frames)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"host-mesh worker: {args.device} requested but CUDA is not "
                           "available (pass --device cpu for the plain versions)")
    proto = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    return worker_main(sys.stdin.buffer, proto, device=str(dev))


if __name__ == "__main__":
    sys.exit(main())
