#!/usr/bin/env python3
"""K7 zoned and K7s zoned, this checkout's kernels against another checkout's.

Times the checkpointed zoned scan (ffd_ckpt_zoned_scan) and its sparse twin
(ffd_ckpt_sparse_zoned_scan) at BASELINE config 3's kernel arguments (50 000
pods; a ring every 16 steps, 4 slots: TorchSolver's defaults) on one card,
built from this checkout's csrc and from OTHER_CHECKOUT's (for example the
parent commit unpacked with `git archive`). The two builds' outputs must be
equal; then the two are timed in turns (this, other, other, this) ROUNDS
times, CUDA events around CALLS calls each.

Usage: python3 karpenter_tpu_torch/tools/zoned_ab.py OTHER_CHECKOUT

Prints the card's name and power limit, then one JSON object {"zoned_ab":
...} with each side's times and the relative change. Exits non-zero
without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUNDS = 3  # (this, other, other, this) rounds
CALLS = 20  # K7 calls per timing


def zoned_ab(other: str) -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build, ffd

    dev = torch.device("cuda")
    build.build()
    mine = {n: build.load(n) for n in ("ffd_kernels", "ffd_sparse_kernels")}
    ffd.zone_v_cap(dev)
    csrc = os.path.join(os.path.abspath(other), "karpenter_tpu_torch", "csrc")
    procs, paths = [], {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in mine:
        src = os.path.join(csrc, f"{name}.cu")
        tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
        paths[name] = build.BUILD_DIR / f"ab_{name}_{tag}.so"
        procs.append(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(paths[name]),
                                       src], stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL))
    assert all(p.wait() == 0 for p in procs), "nvcc failed on the other checkout's csrc"
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    theirs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fname in ("ffd_ckpt_launch", "ffd_ckpt_sparse_launch"):
            if hasattr(lib, fname):
                getattr(lib, fname).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
                getattr(lib, fname).restype = ctypes.c_int
        theirs[name] = lib
    ph = cs.kernel_phase(cs.build_config3_input(cs.PODS), dev)
    args, M = ph["args"], ph["M"]
    sp = cs.sparse_tables(ph["enc"], ph["out"].take_e.shape[0], dev)
    kw = dict(max_claims=M, zone_engine=True, ckpt_every=16, n_ckpt=4)
    fns = {"ffd_ckpt_zoned_scan": lambda: ffd.ffd_solve_ckpt(*args, **kw),
           "ffd_ckpt_sparse_zoned_scan": lambda: ffd.ffd_solve_ckpt_sparse(*sp, *args, **kw)}
    out = {k: {"this_ms": [], "other_ms": []} for k in fns}
    results = {}
    # the wrappers load their library through build._LIBS: swap it per side
    for side, libs in (("this", mine), ("other", theirs)):
        build._LIBS.update(libs)
        for k, fn in fns.items():
            o, ring = fn()
            torch.cuda.synchronize()
            results[(side, k)] = cs._scan_outputs(o) + [*ring.states, ring.prefix]
    for k in fns:
        err = cs.max_abs_err(results[("this", k)], results[("other", k)])
        assert err == 0, f"{k}: this build and the other disagree (max |d| {err})"
    for _ in range(ROUNDS):
        for side, libs in (("this", mine), ("other", theirs), ("other", theirs), ("this", mine)):
            build._LIBS.update(libs)
            for k, fn in fns.items():
                out[k][f"{side}_ms"].append(cs.time_ms(fn, CALLS))
    build._LIBS.update(mine)
    for k, v in out.items():
        v["this_mean_ms"] = sum(v["this_ms"]) / len(v["this_ms"])
        v["other_mean_ms"] = sum(v["other_ms"]) / len(v["other_ms"])
        v["change"] = v["this_mean_ms"] / v["other_mean_ms"] - 1.0
    return dict(kernels=out, other=os.path.abspath(other),
                V=int(args[ffd.ARG_INDEX["v_kind"]].shape[0]), Kv=int(sp[1].shape[1]),
                events=ph["events"], M=M)


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("zoned_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"zoned_ab": zoned_ab(sys.argv[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
