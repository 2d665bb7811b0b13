#!/usr/bin/env python3
"""K13 (the convex backend's admm_pack) of this checkout against another
checkout's, on one card.

Builds csrc/convex_kernels.cu from OTHER_CHECKOUT (for example the parent
commit unpacked with `git archive`) beside this checkout's library, loads
the other checkout's wrapper (solver/cuda/convex.py) against it, and

- captures the K13 tables of chip_smoke.py's phase 8 through
  ConvexSolver(TorchSolver()): BASELINE config 5's one-shot consolidation
  (10 000 nodes, 2 000 candidates), the quality suite's uniform and
  rightsize, the split consolidation and convex_e2e (5 000 pods, 200
  nodes); prints each table's shape and density (feasible cells over
  Sp x Np, the longest row and column);
- holds each side's X and latch on every table to the plain version's
  limit (chip_smoke.hold_admm);
- times both sides at config 5's table in turns (this, other, other,
  this) ROUNDS times, CUDA events around CALLS calls each, and at 0
  iterations (the set-up and the dense write alone);
- splits one config-5 call of each side by kernel name from a
  torch.profiler trace (device ms and kernel count per name);
- lists both builds' ptxas registers and spills of the K13 kernels.

Usage: python3 karpenter_tpu_torch/tools/admm_ab.py OTHER_CHECKOUT

Prints the card's name and power limit, then one JSON object
{"admm_ab": ...}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUNDS = 3  # (this, other, other, this) rounds
CALLS = 5  # calls per timing at config 5
LIB = "convex_kernels"


def _load_other(other: str):
    """The other checkout's K13 library (built here with this build's
    flags), its wrapper module, and ptxas's report (text)."""
    from karpenter_tpu_torch.solver.cuda import build

    root = os.path.abspath(other)
    src = os.path.join(root, "karpenter_tpu_torch", "csrc", f"{LIB}.cu")
    flags = [*build.NVCC_FLAGS, *build.FLAGS.get(LIB, ())]
    tag = hashlib.sha256(open(src, "rb").read() + " ".join(flags).encode()).hexdigest()[:12]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"ab_{LIB}_{tag}.so"
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(path), src],
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    assert proc.returncode == 0, f"nvcc failed on the other checkout's {LIB}.cu:\n{proc.stderr}"
    lib = ctypes.CDLL(str(path))
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for fname in build.LAUNCHERS[LIB]:  # the other checkout's may lack the newer ones
        if hasattr(lib, fname):
            getattr(lib, fname).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
            getattr(lib, fname).restype = ctypes.c_int
    # the other wrapper in this package's namespace: its relative imports
    # (build, ffd, ..convex) resolve to this checkout's modules, and its
    # load(LIB) returns whichever library build._LIBS holds at the call
    wrapper = os.path.join(root, "karpenter_tpu_torch", "solver", "cuda", "convex.py")
    spec = importlib.util.spec_from_file_location("karpenter_tpu_torch.solver.cuda._other_convex",
                                                  wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lib, mod, proc.stderr


CELLS = ("config5", "uniform", "rightsize", "split", "convex_e2e")


def capture_tables(names=CELLS) -> dict:
    """{name: (the five admm_pack tensors, tol, max_iters)}: the first K13
    call of each of phase 8's cells (of `names`) through
    ConvexSolver(TorchSolver())."""
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import backend as tb
    from karpenter_tpu_torch.solver import convex as cv

    tables, saved = {}, cv.admm_pack
    cells = {
        "config5": lambda c: c.consolidate_global(*cs.build_config5_consolidation()),
        "uniform": lambda c: c.solve(cs.build_scenario("uniform")),
        "rightsize": lambda c: c.solve(cs.build_scenario("rightsize")),
        "split": lambda c: c.consolidate_global(*cs.build_split_consolidation()),
        "convex_e2e": lambda c: c.solve(cs.build_e2e_input(cs.CONVEX_E2E_PODS, cs.NODES)),
    }
    try:
        for name in names:
            run = cells[name]

            def record(*args, max_iters, name=name):
                tables.setdefault(name, (tuple(args[:5]), args[5], max_iters))
                return saved(*args, max_iters=max_iters)

            cv.admm_pack = record
            run(cv.ConvexSolver(tb.TorchSolver(max_claims=cs.MAX_CLAIMS)))
    finally:
        cv.admm_pack = saved
    return tables


def density(args) -> dict:
    """Shape and density of one table: feasible cells (nnz) over Sp x Np,
    the real rows (run_count > 0), the longest row and column."""
    req, cnt, _, _, feas = args
    Sp, Np = feas.shape
    nnz = int(feas.sum())
    return dict(Sp=int(Sp), Np=int(Np), R=int(req.shape[1]), rows=int((cnt > 0).sum()), nnz=nnz,
                density=nnz / (Sp * Np), longest_row=int(feas.sum(dim=1).max()),
                longest_col=int(feas.sum(dim=0).max()))


def device_split(fn, tries: int = 6) -> dict:
    """{kernel name: {"ms", "n"}} of one call from the fullest of `tries`
    torch.profiler traces (device time summed per name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_n = {}, 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "admm" in e.name:
                s = split.setdefault(e.name, {"ms": 0.0, "n": 0})
                s["ms"] += e.time_range.elapsed_us() / 1e3
                s["n"] += 1
        n = sum(s["n"] for s in split.values())
        if n > best_n:
            best, best_n = split, n
    return best


def admm_ab(other: str) -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build
    from karpenter_tpu_torch.solver.cuda import convex as tcc

    build.build()
    mine = build.load(LIB)
    theirs, other_mod, their_report = _load_other(other)
    tables = capture_tables()
    sides = {"this": (mine, tcc.admm_pack), "other": (theirs, other_mod.admm_pack)}

    def use(side):
        lib, fn = sides[side]
        build._LIBS[LIB] = lib
        return fn

    out = {"tables": {k: density(v[0]) for k, v in tables.items()}, "holds": {}}
    saved = tcc.admm_pack
    try:
        for side in sides:
            fn = use(side)
            tcc.admm_pack = fn  # hold_admm calls tcc.admm_pack
            out["holds"][side] = {k: cs.hold_admm(list(a), tol, iters)
                                  for k, (a, tol, iters) in tables.items()}
    finally:
        tcc.admm_pack = saved
        build._LIBS[LIB] = mine
    args5, tol5, iters5 = tables["config5"]
    res = {}
    for side in sides:
        fn = use(side)
        X, c = fn(*args5, tol5, max_iters=iters5)
        X2, c2 = fn(*args5, tol5, max_iters=iters5)
        torch.cuda.synchronize()
        assert torch.equal(X, X2) and int(c) == int(c2), f"{side}: two calls disagree"
        res[side] = (X, int(c))
    times = {s: {"ms": [], "ms_iters0": []} for s in sides}
    for _ in range(ROUNDS):
        for side in ("this", "other", "other", "this"):
            fn = use(side)
            times[side]["ms"].append(cs.time_ms(lambda: fn(*args5, tol5, max_iters=iters5), CALLS))
            times[side]["ms_iters0"].append(cs.time_ms(lambda: fn(*args5, tol5, max_iters=0), CALLS))
    for side in sides:
        fn = use(side)
        times[side]["split"] = device_split(lambda: fn(*args5, tol5, max_iters=iters5))
        times[side]["mean_ms"] = sum(times[side]["ms"]) / len(times[side]["ms"])
        times[side]["mean_ms_iters0"] = sum(times[side]["ms_iters0"]) / len(times[side]["ms_iters0"])
        times[side]["conv"] = res[side][1]
    build._LIBS[LIB] = mine
    times["change"] = times["this"]["mean_ms"] / times["other"]["mean_ms"] - 1.0
    times["max_abs_diff_this_other"] = float((res["this"][0] - res["other"][0]).abs().max())
    admm = lambda rep: {k: v for k, v in cs.ptxas_report(rep).items() if "admm" in k}  # noqa: E731
    out.update(config5=times, max_iters=iters5, other=os.path.abspath(other),
               ptxas={"this": admm(build.BUILD_LOG["ptxas"]), "other": admm(their_report)})
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("admm_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"admm_ab": admm_ab(sys.argv[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
