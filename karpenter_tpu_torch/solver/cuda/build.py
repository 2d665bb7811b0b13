"""Build and load the port's CUDA kernels (csrc/ffd_kernels.cu).

nvcc compiles the source for sm_90a into a shared library with a plain C
interface on first use; ctypes loads it. The library lands in
build/karpenter_tpu_torch/ at the repository root, named by a hash of the
source, so an edited source rebuilds and an unchanged one loads at once.
ptxas's resource report (registers, spills per kernel) is kept beside the
library and read into BUILD_LOG either way. A missing nvcc or a failed
build raises.
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
SOURCE = PKG_ROOT / "csrc" / "ffd_kernels.cu"
BUILD_DIR = PKG_ROOT.parent / "build" / "karpenter_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
BUILD_LOG = {"seconds": None, "ptxas": "", "library": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fixed):
        return fixed
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless a library for this exact source exists."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"ffd_kernels_{tag}.so"
    report = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".ffd_kernels_{tag}.{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        report.write_text(proc.stderr)
        os.replace(tmp, lib)
        BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG.update(ptxas=report.read_text() if report.exists() else "",
                     library=str(lib))
    return lib


def load():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for name in ("ffd_scan_launch", "compact_takes_launch", "claim_meta_launch",
                 "ffd_batched_launch", "pack_verdicts_launch", "ffd_ladder_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptrs, ctypes.c_int, ints, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
