#!/usr/bin/env python3
"""The scan kernels of this checkout against another checkout's, on one card.

Builds the four FFD kernel libraries (csrc/ffd_kernels.cu, its sparse
build csrc/ffd_sparse_kernels.cu, its lane-batched build
csrc/ffd_lanes_kernels.cu and the sparse lanes csrc/ffd_lanes_sparse_kernels.cu)
from this checkout and from OTHER_CHECKOUT's csrc (for example the parent
commit unpacked with `git archive`), then

- compares ptxas's report of every kernel the two builds share: registers,
  spill stores and spill loads (a kernel whose numbers moved is listed);
- holds each build's outputs equal and times them in turns (this, other,
  other, this) ROUNDS times, CUDA events around CALLS calls each (fewer
  for the slow K6 rows, SLOW_CALLS): K1 fast (ffd_fast_scan) at the
  50 000-pod surge's kernel arguments, K15 fast (ffd_lanes_fast_scan) at
  8 lanes of them, K15 zoned (ffd_lanes_zoned_scan) at 8 lanes of config
  3's, the checkpointed fast scan (ffd_ckpt_fast_scan, K7
  fast) at the surge's, the checkpointed zoned scan (ffd_ckpt_zoned_scan)
  and its sparse twin (ffd_ckpt_sparse_zoned_scan) at BASELINE config 3's
  (a ring every 16 steps, 4 slots: TorchSolver's defaults), K1 zoned
  (ffd_zoned_scan) at config 3's; the lanes of a sharded solve: K17 fast
  (ffd_sharded_fast_scan) at the surge over Nd 4 run blocks, K17 zoned (ffd_sharded_zoned_scan) and K17s zoned
  (ffd_sharded_sparse_zoned_scan) at config 3's over Nd 4; and the ladder
  scans: K6 fast (ffd_ladder_fast_scan) at the surge_pref cell's ladder
  dispatch, K6 zoned at config3_soft's (dense tables) and its sparse twin
  (ffd_ladder_sparse_zoned_scan, the main path's) on the union index
  tables, and K6 zoned at the relax walk's (chip_smoke.WALK_PODS pods,
  every pod after an app's first relaxes: ffd_ladder_zoned_scan_walk,
  WALK_CALLS calls a timing). K4, the batched consolidation scan, is
  tools/batched_ab.py's.

The JSON also lists both builds' registers and spills of every kernel
(ptxas "this_all", "other_all").

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
AB_LIBS = ("ffd_kernels", "ffd_sparse_kernels", "ffd_lanes_kernels", "ffd_lanes_sparse_kernels")
LANES = 8  # K15's lanes (cohort_surge's, cohort_config3's)
CALLS = 20  # calls per timing
SLOW_CALLS = 5  # calls per timing of K6 (~2-17 ms)
SLOW = ("ffd_ladder_fast_scan", "ffd_ladder_zoned_scan", "ffd_ladder_sparse_zoned_scan")
WALK_CALLS = 1  # calls per timing of K6 at the relax walk (~1 s a call)
SHARD_ND = 4  # K17's run blocks


def _build_other(other: str):
    """The other checkout's four FFD libraries, loaded, and their ptxas
    reports (text)."""
    from karpenter_tpu_torch.solver.cuda import build

    csrc = os.path.join(os.path.abspath(other), "karpenter_tpu_torch", "csrc")
    procs, paths = [], {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in AB_LIBS:
        src = os.path.join(csrc, f"{name}.cu")
        # the included ffd_kernels.cu is part of every library's identity
        tag = hashlib.sha256(open(src, "rb").read()
                             + open(os.path.join(csrc, "ffd_kernels.cu"), "rb").read()).hexdigest()[:12]
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
        for fname in ("ffd_scan_launch", "ffd_ckpt_launch", "ffd_ckpt_sparse_launch",
                      "ffd_lanes_launch", "ffd_lanes_sparse_launch", "ffd_ladder_launch",
                      "ffd_ladder_sparse_launch", "pack_verdicts_launch"):
            if hasattr(lib, fname):
                getattr(lib, fname).argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
                getattr(lib, fname).restype = ctypes.c_int
        libs[name] = lib
    return libs, "".join(reports)


def ptxas_diff(mine: dict, theirs: dict) -> dict:
    """The kernels of both reports whose registers or spills differ, the
    count compared, and this build's whole report."""
    shared = sorted(set(mine) & set(theirs))
    moved = {k: {"this": mine[k], "other": theirs[k]} for k in shared if mine[k] != theirs[k]}
    return dict(compared=len(shared), moved=moved, this_only=sorted(set(mine) - set(theirs)),
                other_only=sorted(set(theirs) - set(mine)), this_all=mine, other_all=theirs)


def scan_ab(other: str) -> dict:
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.solver.cuda import build, ffd

    dev = torch.device("cuda")
    build.build()
    mine = {n: build.load(n) for n in AB_LIBS}
    ffd.scan_rows_budget(dev)  # cached from this build before the swap
    theirs, their_report = _build_other(other)
    ptxas = ptxas_diff(cs.ptxas_report(build.BUILD_LOG["ptxas"]), cs.ptxas_report(their_report))
    surge = cs.kernel_phase(cs.build_input(cs.PODS), dev)
    ph = cs.kernel_phase(cs.build_config3_input(cs.PODS), dev)
    args, M = ph["args"], ph["M"]
    sp = cs.sparse_tables(ph["enc"], ph["out"].take_e.shape[0], dev)
    kw = dict(max_claims=M, zone_engine=True, ckpt_every=16, n_ckpt=4)
    kw_fast = dict(max_claims=surge["M"], zone_engine=False, ckpt_every=16, n_ckpt=4)
    lanes, lanes_c3 = (tuple(a.unsqueeze(0).expand((LANES,) + tuple(a.shape)).contiguous()
                             for a in p["args"]) for p in (surge, ph))
    # K17 at the surge's Nd 4 run blocks; K6 / K6s at the ladder cells' and
    # the relax walk's dispatches
    from karpenter_tpu_torch.solver import backend as tb

    lad_f = cs.ladder_args(cs.build_surge_pref_input(cs.PODS), dev)
    lad_z = cs.ladder_args(cs.build_config3_soft_input(cs.PODS), dev)
    lad_w = cs.ladder_args(cs.build_relax_walk_input(cs.WALK_PODS), dev)
    M6f = tb.initial_claim_bucket(lad_f[4], cs.MAX_CLAIMS)
    M6z = tb.initial_claim_bucket(lad_z[4], cs.MAX_CLAIMS)
    M6w = tb.initial_claim_bucket(lad_w[4], cs.MAX_CLAIMS)
    sp6 = cs.sparse_tables(lad_z[0], lad_z[3]["Sp"], dev,
                           run_ladder=lad_z[2].cpu().numpy()[:len(lad_z[0].run_group)])
    blocks, shared, _ = cs.sharded_args(surge, SHARD_ND, dev, sparse=False)
    blocks_c3, shared_c3, sp_c3 = cs.sharded_args(ph, SHARD_ND, dev, sparse=True)
    fns = {"ffd_fast_scan": lambda: ffd.ffd_solve(*surge["args"], max_claims=surge["M"]),
           "ffd_zoned_scan": lambda: ffd.ffd_solve(*args, max_claims=M, zone_engine=True),
           "ffd_lanes_fast_scan": lambda: ffd.ffd_solve_lanes(*lanes, max_claims=surge["M"]),
           "ffd_lanes_zoned_scan": lambda: ffd.ffd_solve_lanes(*lanes_c3, max_claims=M,
                                                               zone_engine=True),
           "ffd_ckpt_fast_scan": lambda: ffd.ffd_solve_ckpt(*surge["args"], **kw_fast),
           "ffd_ckpt_zoned_scan": lambda: ffd.ffd_solve_ckpt(*args, **kw),
           "ffd_ckpt_sparse_zoned_scan": lambda: ffd.ffd_solve_ckpt_sparse(*sp, *args, **kw),
           "ffd_ladder_fast_scan": lambda: ffd.ffd_solve_ladder(lad_f[2], *lad_f[1], max_claims=M6f),
           "ffd_ladder_zoned_scan": lambda: ffd.ffd_solve_ladder(lad_z[2], *lad_z[1], max_claims=M6z,
                                                                 zone_engine=True),
           "ffd_ladder_sparse_zoned_scan": lambda: ffd.ffd_solve_ladder_sparse(
               lad_z[2], *sp6, *lad_z[1], max_claims=M6z, zone_engine=True),
           "ffd_ladder_zoned_scan_walk": lambda: ffd.ffd_solve_ladder(
               lad_w[2], *lad_w[1], max_claims=M6w, zone_engine=lad_w[0].V > 0),
           "ffd_sharded_fast_scan": lambda: ffd.ffd_solve_sharded(*blocks, *shared,
                                                                  max_claims=surge["M"]),
           "ffd_sharded_zoned_scan": lambda: ffd.ffd_solve_sharded(
               *blocks_c3, *shared_c3, max_claims=M, zone_engine=True),
           "ffd_sharded_sparse_zoned_scan": lambda: ffd.ffd_solve_sharded_sparse(
               *sp_c3, *blocks_c3, *shared_c3, max_claims=M, zone_engine=True)}

    def outputs(k, o):
        if k.startswith("ffd_ladder"):
            return cs._scan_outputs(o) + [o.attempts]
        if not k.startswith("ffd_ckpt"):
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
                calls = WALK_CALLS if k.endswith("_walk") else SLOW_CALLS if k in SLOW else CALLS
                out[k][f"{side}_ms"].append(cs.time_ms(fn, calls))
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
