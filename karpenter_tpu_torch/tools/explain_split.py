#!/usr/bin/env python3
"""Where K12's time goes, phase by phase, on one card.

Builds a copy of this checkout's csrc/class_kernels.cu in which thread 0 of
every CTA of explain_kernel reads %globaltimer (ns, one clock for every SM)
after each mark (MARKS: the grid's phase A, its group constants and its
barrier; the local team's copies, constants, landed copies and sums; then,
for both, phase B's first tile ready and the end, after a CTA barrier the
copy adds). It runs the copy on every team explain_teams allows at
class_contended's cold solve and at surge_e2e's (the inputs of
tools/side_ab.py, made on the CPU), holds each output to the plain version
word for word, and prints for each the µs from the launch's first CTA
start to each mark, the median and the largest over the CTAs that reached
it (each the median over REPS calls after a first). A mark is an exact
line of the kernel's source: an edit there must keep it, or update MARKS.

Usage: python3 karpenter_tpu_torch/tools/explain_split.py

Prints the card's name and power limit, then one JSON object
{"explain_split": ...}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 6  # stamped calls a shape and team (the first dropped)
SLOTS = 16  # stamps a CTA
MAX_CTAS = 1024  # CTAs stamped
# (a line of the source, the mark stamped after it)
MARKS = (
    ("  __shared__ XShared xs;\n", "start"),
    ("    explain_usage(a, sh);\n", "grid: column sums"),
    ("    if ((int)blockIdx.x < a.tiles) explain_consts(a, xs, blockIdx.x);\n",
     "grid: group constants"),
    ("    cg::this_grid().sync();\n", "grid: barrier"),
    ("  for (int i = threadIdx.x; i < Gp * R; i += XT) cp_async4(s_req + i, a.group_req + i);\n",
     "local: copies issued"),
    ("  explain_consts(a, xs, blockIdx.x);\n", "local: group constants"),
    ("  __syncthreads();  // the copies and the zeroed sums\n", "local: copies landed"),
    ("    s_ff[fr * chunk + fe] = wsub(__ldg(&a.node_free[(size_t)fe * R + fr]), "
     "s_ff[fr * chunk + fe]);\n  __syncthreads();\n", "local: sums"),
)
STAMP = ("  if (threadIdx.x == 0 && blockIdx.x < %d) { unsigned long long t_; "
         'asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); '
         "g_explain_stamp[blockIdx.x * %d + %d] = t_; }\n")


def stamped_source(src: str):
    """(the stamped copy of class_kernels.cu, the names of its stamps)."""
    names = []
    for k, (text, name) in enumerate(MARKS):
        assert src.count(text) == 1, f"mark not found once: {text!r}"
        src = src.replace(text, text + STAMP % (MAX_CTAS, SLOTS, k))
        names.append(name)
    ready = "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
    assert src.count(ready) == 1
    src = src.replace(ready, STAMP % (MAX_CTAS, SLOTS, len(names)) + ready)
    names.append("phase B ready")
    end = "    explain_rows<false>(a, xs, sh);\n  }\n}\n"
    assert src.count(end) == 1
    src = src.replace(end, "    explain_rows<false>(a, xs, sh);\n  }\n  __syncthreads();\n"
                      + STAMP % (MAX_CTAS, SLOTS, len(names)) + "}\n")
    names.append("end")
    assert len(names) <= SLOTS
    head = f"__device__ unsigned long long g_explain_stamp[{MAX_CTAS * SLOTS}];\n"
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    src += ('\nextern "C" int explain_stamps(void** p, int, const int* d, void*) {\n'
            "  if (d[0]) return (int)cudaMemcpyFromSymbol(p[0], g_explain_stamp, "
            "sizeof(g_explain_stamp));\n"
            "  void* at = nullptr;\n"
            "  cudaError_t e = cudaGetSymbolAddress(&at, g_explain_stamp);\n"
            "  if (e == cudaSuccess) e = cudaMemset(at, 0, sizeof(g_explain_stamp));\n"
            "  return (int)e;\n}\n")
    return src, names


def explain_split() -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build, ffd
    from karpenter_tpu_torch.tools import side_ab

    dev = torch.device("cuda")
    shapes = {"class_contended": side_ab._explain_inputs(cs.build_class_input(**cs.CLASS_KW)),
              "surge_e2e": side_ab._explain_inputs(cs.build_e2e_input(cs.PODS, cs.NODES))}
    src, names = stamped_source(open(build.SOURCES["class_kernels"]).read())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "explain_split.cu"
    path.write_text(src)
    lib_path = build.BUILD_DIR / "explain_split.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for fn in ("explain_pack_launch", "explain_info", "explain_stamps"):
        getattr(lib, fn).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    real = build._LIBS.get("class_kernels")
    host = (ctypes.c_ulonglong * (MAX_CTAS * SLOTS))()
    res = dict(marks=names, shapes={})
    try:
        build._LIBS["class_kernels"] = lib
        for name, sh in shapes.items():
            a = [t.to(dev) for t in sh["args"]]
            E, G = sh["E"], sh["G"]
            Sp, Ep = a[0].shape
            Gp, R = a[2].shape
            want = ffd.explain_pack_plain(*a, E, G, top_k=side_ab.TOP_K)
            for team in ffd.explain_teams(int(Sp), int(Ep), int(Gp), int(R)):
                info = ffd.explain_team_info(int(Sp), int(Ep), int(Gp), int(R), E, team)
                runs = []
                for _ in range(REPS):
                    assert lib.explain_stamps(None, 0, (ctypes.c_int * 1)(0), None) == 0
                    got = ffd._explain_pack_cuda(*a, E, G, top_k=side_ab.TOP_K, team=team)
                    torch.cuda.synchronize()
                    err = cs.max_abs_err([got], [want])
                    assert err == 0, f"the stamped copy disagrees at {name}, team {team} ({err})"
                    rc = lib.explain_stamps((ctypes.c_void_p * 1)(ctypes.addressof(host)), 1,
                                            (ctypes.c_int * 1)(1), None)
                    assert rc == 0, rc
                    n = min(info["grid"], MAX_CTAS)
                    rows = [[host[c * SLOTS + k] for k in range(len(names))] for c in range(n)]
                    t0 = min(r[0] for r in rows)
                    runs.append({nm: [(r[k] - t0) / 1e3 for r in rows if r[k]]
                                 for k, nm in enumerate(names)})
                runs = runs[1:]
                marks = {}
                for nm in names:
                    if not runs[0][nm]:
                        continue
                    marks[nm] = dict(
                        median_us=statistics.median(statistics.median(r[nm]) for r in runs),
                        max_us=statistics.median(max(r[nm]) for r in runs),
                        ctas=len(runs[0][nm]))
                res["shapes"][f"{name}/team{team}"] = dict(
                    marks=marks, grid=info["grid"], segments=info["segments"],
                    shape=dict(Sp=int(Sp), Ep=int(Ep), Gp=int(Gp), R=int(R), E=E, G=G))
    finally:
        if real is None:
            build._LIBS.pop("class_kernels", None)
        else:
            build._LIBS["class_kernels"] = real
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("explain_split: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"explain_split": explain_split()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
