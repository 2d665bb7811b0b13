#!/usr/bin/env python3
"""The batched consolidation scan (K4) and the arena unpack (K8) of this
checkout against another checkout's, on one card.

Each side runs in a process of its own with its checkout's package first on
sys.path, so the two sides' wrappers and kernels are each their own; only
the FFD scan libraries and the arena library are built (cached under the
checkout's build/). The inputs are made once, by this checkout's
chip_smoke builders, and saved (build/karpenter_tpu_torch/batched_ab_inputs.pt):

- K4 at three shapes: config 5's first search dispatch (511 subset rows in a
  bucket of 512; 10 000 nodes, 2 000 candidates, M 16), the same search's
  second dispatch (its real rows and bucket, recorded from the prefix
  search), and 16 rows of the first small zone fleet (the zoned instance,
  M 16: chip_smoke.small_batched_check's universe and subsets);
- K8 at two packed uploads: the surge's cold adopt (the 36 kernel arguments
  of build_input(50 000)) and config 5's universe (its 36 arguments).

Every worker, on each K4 shape: the outputs' digest (which must agree
between the sides), loop_ms (CUDA events around CALLS_K4 calls),
device_ms (torch.profiler, the median of TRACES traces, one call each), the
team the launch takes and its blocks a SM by the occupancy query
(cudaOccupancyMaxActiveBlocksPerMultiprocessor), the waves that gives, and
per-row stamps (start and end %globaltimer, the SM of the row's first CTA,
its clock64 cycles): the rows' latencies, how many ran at once, the span;
and, where the launch picks its team, loop_ms and device_ms on every team
of TEAMS forced. The stamps come from a copy of the checkout's
ffd_kernels.cu whose K4 kernel is rewritten with stamps around its body
(stamped_source: the one-block ffd_scan_kernel of earlier checkouts, or
the team kernel ffd_batched_kernel), built here and used for one stamped
launch through the checkout's own wrapper (and, for a one-block checkout,
the occupancy query) only. On each
K8 upload: loop_ms of `unpack` (the packed buffer already on the card) and
of `upload_packed` (host parts to typed tensors, CALLS_K8 calls), device_us
of `unpack`, allocations a call (the caching allocator's count), and a host
split of one call by time.perf_counter_ns around its parts (medians of
SPLITS calls): for the one-allocation-a-segment unpack of earlier
checkouts the segment list, one allocation a segment, the ctypes tables and
the launch; for the planned unpack the plan lookup, the one allocation, the
views, the launch tables and the launch. ptxas's registers and spills of
both sides' K4 instances are listed. ncu does not run on the chip
machine: no achieved occupancy or DRAM bytes.

Usage: python3 karpenter_tpu_torch/tools/batched_ab.py OTHER_CHECKOUT [--rounds N]
       python3 karpenter_tpu_torch/tools/batched_ab.py --alone CHECKOUT
OTHER_CHECKOUT (for example the parent commit unpacked with `git archive`):
N rounds (1 by default) of the turns this, other, other, this. --alone:
CHECKOUT alone, twice (the parent's numbers before a change; the inputs are
still made by this checkout). Prints the card's name and power limit, then
one JSON object {"batched_ab": ...} (also written, with every row's
stamps, to chiprun_out/batched_ab.json). Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INPUTS = os.path.join(REPO, "build", "karpenter_tpu_torch", "batched_ab_inputs.pt")

CALLS_K4 = 5  # K4 calls a loop timing (~1-2 ms a call)
CALLS_K8 = 50  # K8 calls a loop timing
TRACES = 3  # profiled calls a shape
SPLITS = 20  # K8 calls split by host clock
K4_SHAPES = ("dispatch_511", "dispatch_2", "zoned_16")
K8_SHAPES = ("surge", "config5_universe")
MAX_STAMP_ROWS = 4096
TEAMS = (1, 2, 4, 8, 16)  # the teams a K4 launch can take (CTAs a row), each forced

# the one-block K4 of earlier checkouts, and its stamped copy (stamped_source)
_BLOCK_KERNEL = """template <bool ZONE>
__global__ void __launch_bounds__(NT) ffd_scan_kernel(ScanArgs a) {
  batch_row_prologue(a);
  scan_body<ZONE, true, false, false, false, false>(a);
}"""
_STAMPED_KERNEL = """__device__ unsigned long long k4_stamps[4 * %d];
template <bool ZONE>
__global__ void __launch_bounds__(NT) ffd_scan_kernel(ScanArgs a) {
  unsigned long long t0;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  batch_row_prologue(a);
  scan_body<ZONE, true, false, false, false, false>(a);
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < %d) {
    unsigned long long t1;
    unsigned sm;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t1));
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
    unsigned long long* s = k4_stamps + 4 * blockIdx.x;
    s[0] = t0; s[1] = t1; s[2] = sm; s[3] = (unsigned long long)(clock64() - c0);
  }
}""" % (MAX_STAMP_ROWS, MAX_STAMP_ROWS)
_STAMPED_EXPORTS = """
extern "C" int k4_stamps_read(void** p, int, const int* d, void*) {
  return (int)cudaMemcpyFromSymbol(p[0], k4_stamps, sizeof(unsigned long long) * 4 * d[0]);
}
// blocks a SM of the fast and the zoned instance at d[0] / d[1] bytes of rows
extern "C" int k4_occupancy(void** p, int, const int* d, void*) {
  int* out = (int*)p[0];
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, ffd_scan_kernel<false>, NT, d[0]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, ffd_scan_kernel<true>, NT, d[1]);
  return (int)e;
}
"""


# the team K4 (ffd_batched_kernel), and its stamped copy: the row's first
# CTA stamps once every CTA of the row is done
_TEAM_KERNEL = """template <bool ZONE, bool MANY>
__global__ void __launch_bounds__(NTC, MANY ? 2 : 1) ffd_batched_kernel(ScanArgs a) {
  const long long b = blockIdx.x / cg::this_cluster().num_blocks();
  batch_row_prologue(a, b);
  scan_body<ZONE, true, false, false, false>(a);
}"""
_STAMPED_TEAM_KERNEL = """__device__ unsigned long long k4_stamps[4 * MAX_STAMP_ROWS];
template <bool ZONE, bool MANY>
__global__ void __launch_bounds__(NTC, MANY ? 2 : 1) ffd_batched_kernel(ScanArgs a) {
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  const long long b = blockIdx.x / cg::this_cluster().num_blocks();
  batch_row_prologue(a, b);
  scan_body<ZONE, true, false, false, false>(a);
  cluster_barrier();
  if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0 && b < MAX_STAMP_ROWS) {
    unsigned long long t1;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* s = k4_stamps + 4 * b;
    s[0] = t0; s[1] = t1; s[2] = sm; s[3] = (unsigned long long)(clock64() - c0);
  }
}""".replace("MAX_STAMP_ROWS", str(MAX_STAMP_ROWS))
_STAMPS_READ = """
extern "C" int k4_stamps_read(void** p, int, const int* d, void*) {
  return (int)cudaMemcpyFromSymbol(p[0], k4_stamps, sizeof(unsigned long long) * 4 * d[0]);
}
"""


def stamped_source(text: str) -> str:
    """A copy of a checkout's ffd_kernels.cu whose K4 kernel stamps every
    row and which exports the stamp read: the one-block ffd_scan_kernel of
    earlier checkouts (then also the occupancy query), or the team kernel
    ffd_batched_kernel (then the copy is the batched library:
    FFD_BATCHED_ONLY)."""
    if _BLOCK_KERNEL in text:
        return text.replace(_BLOCK_KERNEL, _STAMPED_KERNEL) + _STAMPED_EXPORTS
    if _TEAM_KERNEL in text:
        return ("#define FFD_BATCHED_ONLY\n" + text.replace(_TEAM_KERNEL, _STAMPED_TEAM_KERNEL)
                + _STAMPS_READ)
    raise ValueError("no K4 kernel to stamp in this source")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_inputs(path: str) -> None:
    """K4's three shapes and K8's two uploads (see the module docstring),
    on the CPU, saved to `path`."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from karpenter_tpu_torch.disruption.batched import BatchedConsolidationEvaluator
    from karpenter_tpu_torch.solver.backend import TorchSolver, host_kernel_args
    from karpenter_tpu_torch.solver.cuda import consolidate as cons
    from karpenter_tpu_torch.solver.encode import encode, quantize_input

    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    ev = BatchedConsolidationEvaluator(TorchSolver())
    prep = ev.prepare(*cs.build_config5_universe(cs.CONFIG5_NODES, cs.CONFIG5_CANDIDATES))
    calls = []
    real = ev.evaluate_prepared

    def recording(p, subsets):
        calls.append([list(s) for s in subsets])
        return real(p, subsets)

    ev.evaluate_prepared = recording
    k, dispatches, probed, _ = cs._prefix_search(ev, prep, cs.CONFIG5_CANDIDATES)
    assert dispatches == 2 == len(calls), (dispatches, len(calls))

    def rows_of(p, subsets):
        return cons.subset_rows(p.args, p.pod_cand, p.pod_run, subsets, p.node_idx, p.v_delta,
                                p.v_count0_host)

    shapes = {}
    for name, subs in (("dispatch_511", calls[0]), ("dispatch_2", calls[1])):
        shapes[name] = dict(rows=rows_of(prep, subs), n_rows=len(subs), M=ev.max_claims,
                            zone=False, args="config5")
    seed, zinp = cs.fleets_with_nodes(cs.build_zone_input, 1)[0]
    zev = BatchedConsolidationEvaluator(TorchSolver(), max_claims=16)
    zp = zev.prepare(*cs.as_consolidation_universe(zinp))
    assert zp is not None and zp.enc.V > 0
    zsubs = cs.small_subsets(len(zinp.nodes), seed)
    shapes["zoned_16"] = dict(rows=rows_of(zp, zsubs), n_rows=len(zsubs), M=16, zone=True,
                              args="zone")
    uploads = {"surge": host_kernel_args(encode(quantize_input(cs.build_input(cs.PODS))),
                                         TorchSolver._bucket)[0],
               "config5_universe": host_kernel_args(prep.enc, TorchSolver._bucket)[0]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(dict(k4=shapes, args={"config5": cpu(prep.args), "zone": cpu(zp.args)},
                    k8=uploads, search=dict(k=k, dispatches=dispatches, probed=probed)), path)


def _device_trace(fn):
    """(device µs of one call, {name: µs}) from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return sum(by_name.values()), by_name


def _loop_ms(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(calls):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / calls


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in (out.leftover, out.events, *out.state):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def stamp_summary(stamps, n_rows: int) -> dict:
    """Rows' latencies, how many ran at once, and the span, from [B, 4]
    stamps (start ns, end ns, SM, cycles); the rows past n_rows are the
    bucket's padding (empty subsets)."""
    rows = [tuple(int(x) for x in r) for r in stamps]
    t0 = min(r[0] for r in rows)
    lat = [(r[1] - r[0]) / 1e3 for r in rows]
    edges = sorted([(r[0], 1) for r in rows] + [(r[1], -1) for r in rows])
    at_once = best = 0
    for _, d in edges:
        at_once += d
        best = max(best, at_once)
    real = lat[:n_rows]
    return dict(rows=len(rows), sms=len({r[2] for r in rows}), rows_at_once=best,
                span_us=(max(r[1] for r in rows) - t0) / 1e3,
                latency_us=dict(min=min(real), median=statistics.median(real), max=max(real)),
                pad_latency_us=statistics.median(lat[n_rows:]) if len(lat) > n_rows else None,
                start_spread_us=(max(r[0] for r in rows) - t0) / 1e3,
                cycles_median=statistics.median(r[3] for r in rows[:n_rows]),
                per_row=[((r[0] - t0) / 1e3, (r[1] - r[0]) / 1e3, r[2]) for r in rows])


def _stamped_library(checkout: str, build, teams: bool):
    """The stamped copy of a checkout's ffd_kernels.cu (stamped_source),
    built and loaded (argtypes of every launcher it exports: the main
    library's for a one-block checkout, the batched library's for a team
    one)."""
    src = os.path.join(os.path.abspath(checkout), "karpenter_tpu_torch", "csrc", "ffd_kernels.cu")
    text = stamped_source(open(src).read())
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"k4_stamped_{tag}.cu"
    lib = build.BUILD_DIR / f"k4_stamped_{tag}.so"
    cu.write_text(text)
    launchers = build.LAUNCHERS["ffd_batched_kernels" if teams else "ffd_kernels"]
    extra = ("k4_stamps_read",) if teams else ("k4_stamps_read", "k4_occupancy")
    if not lib.exists():
        p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"the stamped K4 failed to build:\n{p.stderr[-4000:]}")
    cdll = ctypes.CDLL(str(lib))
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for fname in (*launchers, *extra):
        fn = getattr(cdll, fname)
        fn.argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return cdll


def _k4_block_side(build, cons, ffd, stamp_lib, args, drows, M, zone, n_rows):
    """Team, occupancy, waves and stamps of a one-block K4 checkout, through
    its stamped copy (the launch goes through the checkout's own wrapper
    with the stamped library in place of its ffd_kernels)."""
    import numpy as np
    import torch

    B = int(drows[0].shape[0])
    a = dict(zip(ffd.ARG_SPEC, args))
    Q, V = int(a["q_kind"].shape[0]), int(a["v_kind"].shape[0])
    dyn = ffd.scan_rows_bytes(Q, 0, V, 0, zone)
    occ = (ctypes.c_int * 2)()
    rc = stamp_lib.k4_occupancy((ctypes.c_void_p * 1)(ctypes.addressof(occ)), 1,
                                ffd._ints([dyn, dyn]), None)
    assert rc == 0, f"k4_occupancy: CUDA error {rc}"
    per_sm = occ[int(zone)]
    real = build._LIBS["ffd_kernels"]
    build._LIBS["ffd_kernels"] = stamp_lib
    try:
        cons.batched_ffd(args, *drows, M, zone)
        torch.cuda.synchronize()
    finally:
        build._LIBS["ffd_kernels"] = real
    host = np.zeros((B, 4), dtype=np.uint64)
    rc = stamp_lib.k4_stamps_read((ctypes.c_void_p * 1)(host.ctypes.data), 1, ffd._ints([B]), None)
    assert rc == 0, f"k4_stamps_read: CUDA error {rc}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    team = dict(shape="one block a row", ctas_per_row=1, threads_per_cta=ffd.NT)
    return team, per_sm, -(-B // (sms * per_sm)), stamp_summary(host, n_rows)


def _k4_team_side(build, cons, ffd, stamp_lib, args, drows, M, zone, n_rows):
    """Team, occupancy, waves and stamps of a checkout whose K4 picks its
    team at launch (cons.batched_team_info; the stamps from its stamped
    copy, launched through the checkout's own wrapper on the same team)."""
    import numpy as np
    import torch

    B = int(drows[0].shape[0])
    info = cons.batched_team_info(args, B, zone)
    real = build._LIBS["ffd_batched_kernels"]
    build._LIBS["ffd_batched_kernels"] = stamp_lib
    try:
        cons.batched_ffd(args, *drows, M, zone)
        torch.cuda.synchronize()
    finally:
        build._LIBS["ffd_batched_kernels"] = real
    host = np.zeros((B, 4), dtype=np.uint64)
    rc = stamp_lib.k4_stamps_read((ctypes.c_void_p * 1)(host.ctypes.data), 1, ffd._ints([B]), None)
    assert rc == 0, f"k4_stamps_read: CUDA error {rc}"
    team = {k: info[k] for k in ("shape", "cl", "ctas_per_row", "threads_per_cta")}
    return team, info["blocks_per_sm"], info["waves"], stamp_summary(host, n_rows)


def _k8_split_block(arena, ffd, build, buf, specs):
    """Host split (ns) of one call of the per-segment-allocation unpack."""
    import torch

    t = [time.perf_counter_ns()]
    segs = arena._segments(specs)
    t.append(time.perf_counter_ns())
    outs = [torch.empty(shape, dtype=dt, device=buf.device) for _, _, dt, shape in segs]
    t.append(time.perf_counter_ns())
    live = [(s, o) for s, o in zip(segs, outs) if s[1] > 0]
    dims = [len(live)]
    for (off, nb, dt, _), _o in live:
        dims += [off, nb, int(dt is torch.bool)]
    ptrs, ints = ffd._ptrs([buf] + [o for _, o in live]), ffd._ints(dims)
    t.append(time.perf_counter_ns())
    rc = build.load("arena_kernels").arena_unpack_launch(ptrs, len(live) + 1, ints, ffd._stream())
    t.append(time.perf_counter_ns())
    assert rc == 0
    return dict(zip(("segments", "allocations", "tables", "launch"),
                    (b - a for a, b in zip(t, t[1:]))))


def _k8_split_plan(arena, buf, specs):
    """Host split (ns) of one call of the planned unpack, its steps one by
    one as arena.unpack_block takes them."""
    import torch

    t = [time.perf_counter_ns()]
    plan = arena.unpack_plan(specs)
    t.append(time.perf_counter_ns())
    block = torch.empty((plan.size,), dtype=torch.uint8, device=buf.device)
    t.append(time.perf_counter_ns())
    plan.views(block)
    t.append(time.perf_counter_ns())
    ptrs = (ctypes.c_void_p * 2)(buf.data_ptr(), block.data_ptr())
    t.append(time.perf_counter_ns())
    arena._launch(ptrs, plan.dims)
    t.append(time.perf_counter_ns())
    return dict(zip(("plan", "allocation", "views", "tables", "launch"),
                    (b - a for a, b in zip(t, t[1:]))))


def worker(checkout: str) -> dict:
    """One side's measurements (see the module docstring)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    sys.path.insert(1, REPO)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import arena, build, ffd
    from karpenter_tpu_torch.solver.cuda import consolidate as cons

    assert os.path.abspath(cons.__file__).startswith(os.path.abspath(checkout)), cons.__file__
    build.SOURCES = {k: v for k, v in build.SOURCES.items()
                     if k.startswith("ffd_") or k == "arena_kernels"}
    teams = hasattr(cons, "batched_team_info")
    t0 = time.perf_counter()
    import threading

    box = {}  # the stamped copy builds beside the checkout's libraries
    th = threading.Thread(target=lambda: box.update(lib=_stamped_library(checkout, build, teams)))
    th.start()
    build.load()
    th.join()
    stamp_lib = box["lib"]
    build_s = time.perf_counter() - t0
    regs = {k: v for k, v in cs.ptxas_report(build.BUILD_LOG["ptxas"]).items()
            if k.startswith(("ffd_scan_kernel", "ffd_batched_kernel", "arena_unpack"))}
    dev = torch.device("cuda")
    data = torch.load(INPUTS, weights_only=False)
    args = {k: tuple(t.to(dev) for t in v) for k, v in data["args"].items()}
    k4 = {}
    for name in K4_SHAPES:
        sh = data["k4"][name]
        a = args[sh["args"]]
        drows = cons.upload_rows(sh["rows"], dev)
        M, zone = sh["M"], sh["zone"]

        def call():
            return cons.batched_ffd(a, *drows, M, zone)

        r = dict(digest=_digest(call()), B=int(drows[0].shape[0]), rows=sh["n_rows"],
                 Sp=int(drows[0].shape[1]), M=M, zone=zone, NC=int(drows[2].shape[1]),
                 E=int(a[ffd.ARG_INDEX["node_free"]].shape[0]))
        r["loop_ms"] = _loop_ms(call, CALLS_K4)
        traces = sorted((_device_trace(call) for _ in range(TRACES)), key=lambda x: x[0])
        r["device_ms"] = traces[len(traces) // 2][0] / 1e3
        r["device_by_name_us"] = traces[len(traces) // 2][1]
        if teams:
            team, per_sm, waves, st = _k4_team_side(build, cons, ffd, stamp_lib, a, drows, M,
                                                    zone, sh["n_rows"])
        else:
            team, per_sm, waves, st = _k4_block_side(build, cons, ffd, stamp_lib, a, drows, M,
                                                     zone, sh["n_rows"])
        r.update(team=team, blocks_per_sm=per_sm, waves=waves, stamps=st)
        if teams:  # every team the launch can take, forced: loop and device ms
            r["teams_ms"] = {}
            for cl in TEAMS:
                def forced(cl=cl):
                    return cons._batched_ffd_cuda(a, *drows, M, zone, team=cl)

                assert _digest(forced()) == r["digest"], (name, cl)
                r["teams_ms"][cl] = dict(loop_ms=_loop_ms(forced, CALLS_K4),
                                         device_ms=_device_trace(forced)[0] / 1e3)
        k4[name] = r
    k8 = {}
    for name in K8_SHAPES:
        parts, nbytes, specs = arena.pack(data["k8"][name])
        host = np.concatenate(parts)
        buf = torch.from_numpy(host).to(dev)
        got = arena.unpack(buf, specs)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for g in got:
            h.update(g.cpu().numpy().tobytes())
        r = dict(digest=h.hexdigest()[:16], nbytes=nbytes, segments=len(specs))
        r["unpack_loop_ms"] = _loop_ms(lambda: arena.unpack(buf, specs), CALLS_K8)
        r["upload_loop_ms"] = _loop_ms(lambda: arena.upload_packed(parts, nbytes, specs, dev),
                                       CALLS_K8)
        traces = sorted((_device_trace(lambda: arena.unpack(buf, specs)) for _ in range(TRACES)),
                        key=lambda x: x[0])
        r["device_us"], r["device_by_name_us"] = traces[len(traces) // 2]
        torch.cuda.synchronize()
        n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        arena.unpack(buf, specs)
        r["allocations_a_call"] = torch.cuda.memory_stats()["allocation.all.allocated"] - n0
        splits = []
        for _ in range(SPLITS):
            torch.cuda.synchronize()
            splits.append(_k8_split_plan(arena, buf, specs) if hasattr(arena, "unpack_plan")
                          else _k8_split_block(arena, ffd, build, buf, specs))
        r["split_us"] = {k: statistics.median(s[k] for s in splits) / 1e3 for k in splits[0]}
        r["split_total_us"] = sum(r["split_us"].values())
        k8[name] = r
    return dict(k4=k4, k8=k8, ptxas=regs, build_s=build_s, checkout=os.path.abspath(checkout),
                teams=teams, search=data["search"])


def _run_worker(checkout: str) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", checkout],
                       capture_output=True, text=True, timeout=1200)
    if p.returncode != 0:
        raise RuntimeError(f"batched_ab worker for {checkout} failed ({p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def _mean_floats(rs, key: str, name: str) -> dict:
    """The mean over runs of every float of rs[i][key][name] (stamps'
    latencies and span included)."""
    first = rs[0][key][name]
    out = {k: statistics.mean(r[key][name][k] for r in rs) for k, v in first.items()
           if isinstance(v, float)}
    if key == "k4":
        out["span_us"] = statistics.mean(r[key][name]["stamps"]["span_us"] for r in rs)
        out["latency_median_us"] = statistics.mean(
            r[key][name]["stamps"]["latency_us"]["median"] for r in rs)
    if key == "k8":
        out["split_us"] = {k: statistics.mean(r[key][name]["split_us"][k] for r in rs)
                           for k in first["split_us"]}
    return out


def main() -> int:
    import torch

    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if argv == ["--make-inputs"]:
        make_inputs(INPUTS)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    alone = argv[:1] == ["--alone"]
    if alone:
        argv = argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("batched_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--make-inputs"],
                       capture_output=True, text=True, timeout=1200)
    if p.returncode != 0:
        raise RuntimeError(f"batched_ab inputs failed:\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
    inputs_s = time.perf_counter() - t0
    other = argv[0]
    turns = ([("other", other)] * 2 if alone
             else [("this", REPO), ("other", other), ("other", other), ("this", REPO)] * rounds)
    runs = {"this": [], "other": []}
    for side, checkout in turns:
        runs[side].append(_run_worker(checkout))
    summary = {}
    for key, names in (("k4", K4_SHAPES), ("k8", K8_SHAPES)):
        for name in names:
            s = {}
            for side, rs in runs.items():
                if not rs:
                    continue
                digests = {r[key][name]["digest"] for r in rs}
                assert len(digests) == 1, (name, side, digests)
                s[side] = _mean_floats(rs, key, name)
                last = rs[-1][key][name]
                s[side].update({k: last[k] for k in ("team", "blocks_per_sm", "waves")
                                if k in last})
                if key == "k4":
                    st = last["stamps"]
                    s[side]["stamps"] = {k: st[k] for k in st if k != "per_row"}
                    if "teams_ms" in last:
                        s[side]["teams_ms"] = last["teams_ms"]
                else:
                    s[side]["allocations_a_call"] = last["allocations_a_call"]
                s[side]["digest"] = digests.pop()
            if "other" in s and "this" in s:
                assert s["this"]["digest"] == s["other"]["digest"], (name, "the sides disagree")
                s["change"] = {k: s["this"][k] / s["other"][k] - 1.0 for k in s["this"]
                               if isinstance(s["this"][k], float) and s["other"].get(k)}
            r0 = (runs["this"] or runs["other"])[0][key][name]
            s["shape"] = {k: r0[k] for k in ("B", "rows", "Sp", "M", "zone", "NC", "E",
                                             "nbytes", "segments") if k in r0}
            summary[f"{key}_{name}"] = s
    line = dict(shapes=summary, card=card, rounds=rounds, inputs_s=inputs_s,
                ptxas={side: rs[0]["ptxas"] for side, rs in runs.items() if rs},
                build_s={side: [r["build_s"] for r in rs] for side, rs in runs.items() if rs},
                search=(runs["this"] or runs["other"])[0]["search"],
                this=None if alone else REPO, other=os.path.abspath(other),
                ncu="not run: ncu does not work on the chip machine",
                wall_s=time.perf_counter() - t0)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "batched_ab.json"), "w") as f:
        json.dump(dict(batched_ab=line, runs=runs), f, indent=1)
    print(json.dumps({"batched_ab": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
