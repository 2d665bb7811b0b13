#!/usr/bin/env python3
"""The scan kernels of this checkout against another checkout's, on one card.

Builds the two FFD kernel libraries (csrc/ffd_kernels.cu and its sparse
build csrc/ffd_sparse_kernels.cu) from this checkout and from
OTHER_CHECKOUT's csrc (for example the parent commit unpacked with `git
archive`), then

- compares ptxas's report of every kernel the two builds share: registers,
  spill stores and spill loads (a kernel whose numbers moved is listed);
- holds each build's outputs equal and times them in turns (this, other,
  other, this) ROUNDS times, CUDA events around CALLS calls each: K1 fast
  (ffd_fast_scan) at the 50 000-pod surge's kernel arguments, and the
  checkpointed zoned scan (ffd_ckpt_zoned_scan) and its sparse twin
  (ffd_ckpt_sparse_zoned_scan) at BASELINE config 3's (a ring every 16
  steps, 4 slots: TorchSolver's defaults).

Usage: python3 karpenter_tpu_torch/tools/scan_ab.py OTHER_CHECKOUT

Prints the card's name and power limit, then one JSON object {"scan_ab":
...} with the ptxas comparison and each side's times and relative change.
Exits non-zero without CUDA.
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
CALLS = 20  # calls per timing


def _build_other(other: str):
    """The other checkout's two FFD libraries, loaded, and their ptxas
    reports (text)."""
    from karpenter_tpu_torch.solver.cuda import build

    csrc = os.path.join(os.path.abspath(other), "karpenter_tpu_torch", "csrc")
    procs, paths = [], {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("ffd_kernels", "ffd_sparse_kernels"):
        src = os.path.join(csrc, f"{name}.cu")
        tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
        paths[name] = build.BUILD_DIR / f"ab_{name}_{tag}.so"
        procs.append(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(paths[name]),
                                       src], stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))
    reports = [p.communicate()[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "nvcc failed on the other checkout's csrc"
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fname in ("ffd_scan_launch", "ffd_ckpt_launch", "ffd_ckpt_sparse_launch"):
            if hasattr(lib, fname):
                getattr(lib, fname).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
                getattr(lib, fname).restype = ctypes.c_int
        libs[name] = lib
    return libs, "".join(reports)


def ptxas_diff(mine: dict, theirs: dict) -> dict:
    """The kernels of both reports whose registers or spills differ, and
    the count compared."""
    shared = sorted(set(mine) & set(theirs))
    moved = {k: {"this": mine[k], "other": theirs[k]} for k in shared if mine[k] != theirs[k]}
    return dict(compared=len(shared), moved=moved, this_only=sorted(set(mine) - set(theirs)))


def scan_ab(other: str) -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build, ffd

    dev = torch.device("cuda")
    build.build()
    mine = {n: build.load(n) for n in ("ffd_kernels", "ffd_sparse_kernels")}
    ffd.zone_v_cap(dev)
    theirs, their_report = _build_other(other)
    ptxas = ptxas_diff(cs.ptxas_report(build.BUILD_LOG["ptxas"]), cs.ptxas_report(their_report))
    surge = cs.kernel_phase(cs.build_input(cs.PODS), dev)
    ph = cs.kernel_phase(cs.build_config3_input(cs.PODS), dev)
    args, M = ph["args"], ph["M"]
    sp = cs.sparse_tables(ph["enc"], ph["out"].take_e.shape[0], dev)
    kw = dict(max_claims=M, zone_engine=True, ckpt_every=16, n_ckpt=4)
    fns = {"ffd_fast_scan": lambda: ffd.ffd_solve(*surge["args"], max_claims=surge["M"]),
           "ffd_ckpt_zoned_scan": lambda: ffd.ffd_solve_ckpt(*args, **kw),
           "ffd_ckpt_sparse_zoned_scan": lambda: ffd.ffd_solve_ckpt_sparse(*sp, *args, **kw)}

    def outputs(k, o):
        if k == "ffd_fast_scan":
            return cs._scan_outputs(o)
        o, ring = o
        return cs._scan_outputs(o) + [*ring.states, ring.prefix]

    out = {k: {"this_ms": [], "other_ms": []} for k in fns}
    results = {}
    # the wrappers load their library through build._LIBS: swap it per side
    for side, libs in (("this", mine), ("other", theirs)):
        build._LIBS.update(libs)
        for k, fn in fns.items():
            o = fn()
            torch.cuda.synchronize()
            results[(side, k)] = outputs(k, o)
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
    return dict(kernels=out, ptxas=ptxas, other=os.path.abspath(other),
                V=int(args[ffd.ARG_INDEX["v_kind"]].shape[0]), Kv=int(sp[1].shape[1]),
                events=ph["events"], M=M, surge_M=surge["M"])


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(json.dumps({"scan_ab": scan_ab(sys.argv[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
