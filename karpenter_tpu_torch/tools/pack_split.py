#!/usr/bin/env python3
"""Where the delta pack's time goes, phase by phase, on one card.

Builds a copy of this checkout's csrc/ffd_kernels.cu in which thread 0 of
every CTA of pack_delta_kernel stamps clock64() at the phase boundaries
(MARKS: each after a CTA barrier that the copy adds, and on both sides of
each cluster barrier), runs it at the surge's and class_contended's inner
solve's outputs and at chip_smoke.build_claim_table's M 8 192 table, on
clusters of CLS CTAs, and prints for each the phases in µs at the card's
max SM clock (each the largest over the CTAs, the median over REPS
calls after a first), the whole kernel's stamped span, and the copy's loop
time (CUDA events, CALLS calls). The copy's buffer is held to the plain
version's word for word. A mark is an exact line of the kernel's source:
an edit there must keep it, or update MARKS.

Usage: python3 karpenter_tpu_torch/tools/pack_split.py

Prints the card's name and power limit, then one JSON object
{"pack_split": ...}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLS = (8, 16)  # cluster sizes stamped
REPS = 5  # stamped calls a cluster size (the first dropped)
CALLS = 50  # calls a loop timing
SLOTS = 32  # stamps a CTA
# (a line of the kernel, the phase that ends before it); a cluster barrier
# is stamped on both sides ("before barrier", "after barrier")
MARKS = (
    ("  // 1. take counts, a warp a run row", "start"),
    ("  // claim rows and their hashes, a warp a claim", "take counts"),
    ("  // this CTA's slice of the hash table; leftover and used", "claim rows"),
    ("  const int n = sc[1];", "entry bases"),
    ("  for (long long i = (long long)n + (long long)rk * NT + tid; i < a.cap;", "pairs"),
    ("  // the claims' hashes into the table: the lowest claim of each hash a warp", "pairs tail"),
    ("  __syncthreads();\n  for (int i = tid; i < nm; i += NT) sh.lrank[i] =", "first equal"),
    ("  const unsigned reps = block_exclusive_scan", "representatives"),
    ("  if (wid == 0 && lane < ncl) *peer(&rtot[rk], lane)", "ranks"),
    ("  for (int i = tid; i < (nm >> 1); i += NT) {", "uniq"),
    ("  if (rk == 0 && tid == 0) {\n    out[0] =", "mid16"),
)
STAMP = ("  { __syncthreads(); if (threadIdx.x == 0) "
         "g_pack_stamp[blockIdx.x * %d + %d] = clock64(); }\n")


def stamped_source(src: str):
    """(the stamped copy of ffd_kernels.cu, the names of its stamps)."""
    a = src.index("template <int HB>\n__global__ void __launch_bounds__(NT, 1) pack_delta_kernel")
    b = src.index("// The wide re-fetch's type-mask words")
    body, names, k = src[a:b], [], 0
    for text, name in MARKS:
        assert body.count(text) == 1, f"mark not found once in pack_delta_kernel: {text!r}"
        at = body.index(text)
        body = body[:at] + STAMP % (SLOTS, k) + body[at:]
        names.append(name)
        k += 1
    parts = body.split("  cluster_barrier();\n")
    body = parts[0]
    for p in parts[1:]:
        body += (STAMP % (SLOTS, k) + "  cluster_barrier();\n" + STAMP % (SLOTS, k + 1) + p)
        names += ["before barrier", "after barrier"]
        k += 2
    assert k <= SLOTS
    # the stamps in source order
    order = sorted(range(k),
                   key=lambda i: body.index(f"g_pack_stamp[blockIdx.x * {SLOTS} + {i}]"))
    out = (src[:a] + f"__device__ long long g_pack_stamp[16 * {SLOTS}];\n" + body + src[b:]
           + '\nextern "C" int pack_stamps(void** p, int, const int*, void*) {\n'
           "  return (int)cudaMemcpyFromSymbol(p[0], g_pack_stamp, sizeof(g_pack_stamp));\n}\n")
    return out, [(i, names[i]) for i in order]


def pack_split() -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build, ffd

    dev = torch.device("cuda")
    build.build()
    src, order = stamped_source(open(build.SOURCES["ffd_kernels"]).read())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "pack_split.cu"
    path.write_text(src)
    lib_path = build.BUILD_DIR / "pack_split.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for fn in ("pack_delta_launch", "pack_stamps"):
        getattr(lib, fn).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    mhz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    shapes = {name: (ph["out"], ph["cap"], ph["cap_u"]) for name, ph in (
        ("surge", cs.kernel_phase(cs.build_input(cs.PODS), dev, plain=False)),
        ("class_contended", cs.kernel_phase(cs.build_class_input(**cs.CLASS_KW), dev,
                                            plain=False)))}
    shapes["table_8k"] = cs.build_claim_table(dev)
    real = build.load()
    res = dict(order=[n for _, n in order], sm_mhz=mhz, shapes={})
    try:
        build._LIBS["ffd_kernels"] = lib
        for name, (out, cap, cap_u) in shapes.items():
            args = (out.take_e, out.take_c, out.leftover, out.state, cap, cap_u)
            ref = ffd.pack_delta_plain(*args)
            for cl in CLS:
                got = ffd._pack_delta_cuda(*args, cl=cl)
                torch.cuda.synchronize()
                err = cs.max_abs_err([got], [ref])
                assert err == 0, f"the stamped copy disagrees at {name}, {cl} CTAs ({err})"
                runs = []
                for _ in range(REPS):
                    ffd._pack_delta_cuda(*args, cl=cl)
                    torch.cuda.synchronize()
                    host = (ctypes.c_longlong * (16 * SLOTS))()
                    rc = lib.pack_stamps((ctypes.c_void_p * 1)(ctypes.addressof(host)), 1,
                                         (ctypes.c_int * 1)(0), None)
                    assert rc == 0, rc
                    runs.append([[host[c * SLOTS + i] for i, _ in order] for c in range(cl)])
                runs = runs[1:]
                phases = {}
                for j in range(1, len(order)):
                    key = f"{j:02d} {order[j - 1][1]} -> {order[j][1]}"
                    phases[key] = statistics.median(
                        max(r[c][j] - r[c][j - 1] for c in range(cl)) for r in runs) / mhz
                span = statistics.median(max(r[c][-1] - r[c][0] for c in range(cl))
                                         for r in runs) / mhz
                res["shapes"][f"{name}_cl{cl}"] = dict(
                    phases_us=phases, span_us=span,
                    loop_ms=cs.time_ms(lambda: ffd._pack_delta_cuda(*args, cl=cl), CALLS))
    finally:
        build._LIBS["ffd_kernels"] = real
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pack_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"pack_split": pack_split()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
