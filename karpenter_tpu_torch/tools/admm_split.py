#!/usr/bin/env python3
"""Where K13's time goes, phase by phase, on one card.

Builds a copy of this checkout's csrc/convex_kernels.cu in which thread 0
of block 0 stamps clock64() at the start, after every grid barrier and at
the end, and thread 0 of row team 0 (block 0) at the boundaries of its
row's three passes; runs it on BASELINE config 5's K13 table (captured
through ConvexSolver(TorchSolver()).consolidate_global, as
tools/admm_ab.py does) and prints, in µs at the card's max SM clock: the
layout's four phases, the mean of each phase an iteration (its barrier
included), the row team's passes and reductions, and the dense write.
The copy's X is held to the committed kernel's bit for bit.

Usage: python3 karpenter_tpu_torch/tools/admm_split.py

Prints the card's name and power limit, then one JSON object
{"admm_split": ...}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LIB = "convex_kernels"
STAMPS = 4096
# the row team's marks: (text in row_phase, the same text with its stamp)
ROW_MARKS = (
    ("      const int tid = threadIdx.x;\n", "      const int tid = threadIdx.x;\n      STAMP2(0);\n"),
    ("      const float gmin = team_reduce<1>(lo, tm, red);\n",
     "      STAMP2(1);\n      const float gmin = team_reduce<1>(lo, tm, red);\n"),
    ("#define EXPW(g) expf", "      STAMP2(2);\n#define EXPW(g) expf"),
    ("      const float Z = team_reduce<2>(z, tm, red);\n",
     "      STAMP2(3);\n      const float Z = team_reduce<2>(z, tm, red);\n      STAMP2(4);\n"),
    ("      res = team_reduce<0>(res, tm, red);\n",
     "      STAMP2(5);\n      res = team_reduce<0>(res, tm, red);\n      STAMP2(6);\n"),
)
ROW_PARTS = ("pass1", "min_max_reduce", "pass2", "z_reduce", "pass3", "res_reduce")
HEADER = """
__device__ long long g_stamp[%d];
__device__ long long g_stamp2[%d];
#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0 && stamp_i < %d) \\
    g_stamp[stamp_i] = clock64(); ++stamp_i; } while (0)
#define STAMP2(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 && it < %d) \\
    g_stamp2[it * 8 + (k)] = clock64(); } while (0)
""" % (STAMPS, STAMPS, STAMPS, STAMPS // 8)
FOOTER = """
extern "C" int admm_stamps(void** p, int n, const int* d, void* st) {
  return (int)cudaMemcpyFromSymbol(p[0], n == 2 ? g_stamp2 : g_stamp, sizeof(g_stamp));
}
"""


def stamped_source(src: str) -> str:
    """The kernel source with the stamps put in."""
    s = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    k = s.index("admm_kernel(Admm<")
    body = s.index("{", k) + 1
    s = s[:body] + "\n  int stamp_i = 0;\n  STAMP();" + s[body:]
    end = s.index("dense_write(a, gw, nw);", k)
    s = s[:end] + "dense_write(a, gw, nw);\n  STAMP();" + s[end + len("dense_write(a, gw, nw);"):]
    s = re.sub(r"grid\.sync\(\);", "grid.sync(); STAMP();", s)
    for old, new in ROW_MARKS:
        assert old in s, f"admm_split: the row phase no longer holds {old!r}"
        s = s.replace(old, new)
    return s + FOOTER


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def admm_split() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build
    from karpenter_tpu_torch.solver.cuda import convex as tcc
    from karpenter_tpu_torch.tools.admm_ab import capture_tables

    build.build()
    mine = build.load(LIB)
    src = build.BUILD_DIR / "admm_split.cu"
    src.write_text(stamped_source(build.SOURCES[LIB].read_text()))
    so = build.BUILD_DIR / "admm_split.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *build.FLAGS.get(LIB, ()), "-o",
                           str(so), str(src)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                          text=True)
    assert proc.returncode == 0, f"nvcc failed on the stamped copy:\n{proc.stderr}"
    lib = ctypes.CDLL(str(so))
    for fname in build.LAUNCHERS[LIB] + ("admm_stamps",):
        getattr(lib, fname).argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        getattr(lib, fname).restype = ctypes.c_int
    args, tol, iters = capture_tables(("config5",))["config5"]
    want, _ = tcc.admm_pack(*args, tol, max_iters=iters)
    build._LIBS[LIB] = lib
    try:
        ms = cs.time_ms(lambda: tcc.admm_pack(*args, tol, max_iters=iters), 3)
        got, _ = tcc.admm_pack(*args, tol, max_iters=iters)
        torch.cuda.synchronize()
        bufs = [(ctypes.c_longlong * STAMPS)() for _ in range(2)]
        for n, buf in enumerate(bufs, 1):
            rc = lib.admm_stamps((ctypes.c_void_p * 1)(ctypes.addressof(buf)), n,
                                 (ctypes.c_int * 1)(0), None)
            assert rc == 0, rc
        per = tcc.kernel_info(*args[4].shape, args[0].shape[1])["barriers_per_iteration"]
    finally:
        build._LIBS[LIB] = mine
    assert torch.equal(got, want), "the stamped kernel's X differs from the committed kernel's"
    mhz = max_sm_mhz()
    n = 6 + per * iters
    st = np.array(bufs[0][:n], dtype=np.float64) / mhz  # µs
    d = np.diff(st)
    phases = [d[4 + q:4 + per * iters:per] for q in range(per)]
    rows = np.array(bufs[1][:8 * min(iters, STAMPS // 8)], dtype=np.float64).reshape(-1, 8)
    rd = np.diff(rows[:, :7] / mhz, axis=1)[min(50, len(rows) - 1):]
    return dict(
        ms_events=ms, ms_stamped=(st[-1] - st[0]) / 1e3, max_sm_mhz=mhz, iterations=iters,
        layout_us=dict(zip(("P0", "P1", "P2", "P3"), (float(x) for x in d[:4]))),
        iteration_us={name: dict(mean=float(p.mean()), min=float(p.min()), max=float(p.max()))
                      for name, p in zip(("slot_sums", "column_sums", "row_update"), phases)},
        row_team0_us={k: float(v) for k, v in zip(ROW_PARTS, rd.mean(axis=0))},
        dense_write_us=float(d[4 + per * iters]))


def main() -> int:
    import torch

    if len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("admm_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"admm_split": admm_split()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
