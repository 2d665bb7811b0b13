"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles each source for sm_90a into a shared library with a plain C
interface on first use; ctypes loads it. One nvcc process per source, all
started together, so the build takes as long as the slowest source. Each
library lands in build/karpenter_tpu_torch/ at the repository root, named
by a hash of its source and of the sources it includes (the sparse scan
instances are ffd_kernels.cu built a second time with FFD_SPARSE_ONLY, the
lane-batched scan a third time with FFD_LANES_ONLY), so
an edited source rebuilds and an unchanged one loads at once. ptxas's
resource report (registers, spills per kernel) is kept beside each library
and read into BUILD_LOG either way. A missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[2]
SOURCES = {
    "ffd_kernels": PKG_ROOT / "csrc" / "ffd_kernels.cu",
    "ffd_sparse_kernels": PKG_ROOT / "csrc" / "ffd_sparse_kernels.cu",
    "ffd_lanes_kernels": PKG_ROOT / "csrc" / "ffd_lanes_kernels.cu",
    "arena_kernels": PKG_ROOT / "csrc" / "arena_kernels.cu",
    "class_kernels": PKG_ROOT / "csrc" / "class_kernels.cu",
    "convex_kernels": PKG_ROOT / "csrc" / "convex_kernels.cu",
}
# sources a library includes besides its own (their bytes enter its hash)
INCLUDES = {"ffd_sparse_kernels": (SOURCES["ffd_kernels"],),
            "ffd_lanes_kernels": (SOURCES["ffd_kernels"],)}
# the launchers each library exports, all (void** ptrs, int n, const int* dims, void* stream)
# (the three *_zone_max_v queries take the same arguments and ignore them)
LAUNCHERS = {
    "ffd_kernels": ("ffd_scan_launch", "compact_takes_launch", "claim_meta_launch",
                    "ffd_batched_launch", "pack_verdicts_launch", "ffd_ladder_launch",
                    "ffd_ckpt_launch", "pack_outputs_launch", "ffd_zone_max_v"),
    "ffd_sparse_kernels": ("ffd_scan_sparse_launch", "ffd_ladder_sparse_launch",
                           "ffd_ckpt_sparse_launch", "ffd_sparse_zone_max_v"),
    "ffd_lanes_kernels": ("ffd_lanes_launch", "ffd_lanes_zone_max_v"),
    "arena_kernels": ("arena_unpack_launch", "apply_events_launch", "pad_lanes_launch"),
    "class_kernels": ("gang_commit_launch", "preemption_plan_launch", "explain_pack_launch"),
    "convex_kernels": ("admm_pack_launch",),
}
# flags of one library besides NVCC_FLAGS: K13 keeps the JAX expression
# order, so nvcc may not contract a * b + c into an FMA there
FLAGS = {"convex_kernels": ("-fmad=false",)}
BUILD_DIR = PKG_ROOT.parent / "build" / "karpenter_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}
# seconds: wall time of the last build that compiled anything; ptxas: the
# reports of every library, concatenated; libraries: name -> path
BUILD_LOG = {"seconds": None, "ptxas": "", "libraries": {}}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fixed):
        return fixed
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    src = b"".join(f.read_bytes() for f in (SOURCES[name], *INCLUDES.get(name, ())))
    flags = " ".join((*NVCC_FLAGS, *FLAGS.get(name, ())))
    tag = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build() -> dict:
    """Compile every source whose library is missing, one nvcc each, all
    running at once; returns {name: library path}."""
    libs = {name: _library(name) for name in SOURCES}
    missing = [name for name, lib in libs.items() if not lib.exists()]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in missing:
            lib = libs[name]
            tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.so")
            err = open(lib.with_suffix(".ptxas.tmp"), "w")
            procs.append((name, tmp, err, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *FLAGS.get(name, ()), "-o", str(tmp),
                 str(SOURCES[name])],
                stdout=subprocess.DEVNULL, stderr=err)))
        failed = []
        for name, tmp, err, proc in procs:
            rc = proc.wait()
            err.close()
            report = libs[name].with_suffix(".ptxas.txt")
            os.replace(err.name, report)
            if rc != 0:
                failed.append(f"{name} ({rc}):\n{report.read_text()}")
            else:
                os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        BUILD_LOG["seconds"] = time.perf_counter() - t0
    reports = [lib.with_suffix(".ptxas.txt") for lib in libs.values()]
    BUILD_LOG.update(
        ptxas="".join(r.read_text() for r in reports if r.exists()),
        libraries={name: str(lib) for name, lib in libs.items()},
    )
    return libs


def load(name: str = "ffd_kernels"):
    """The loaded kernel library `name` (a key of SOURCES), every library
    built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    paths = build()
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for n, path in paths.items():
        if n in _LIBS:
            continue
        cdll = ctypes.CDLL(str(path))
        for fname in LAUNCHERS[n]:
            fn = getattr(cdll, fname)
            fn.argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIBS[n] = cdll
    return _LIBS[name]
