"""Build and load the hand-written CUDA kernels.

Each csrc/<name>.cu has a plain C interface.  It is compiled by nvcc for
Hopper (sm_90a) into a shared library, cached under _build/ by a hash of
its source, the shared device header (csrc/mmc_common.cuh) and the flags,
and loaded with ctypes; the op module that uses it declares the argument
types.  Nothing is compiled at import: the first launch builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
COMMON_HEADER = CSRC_DIR / "mmc_common.cuh"  # included by every kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name):
    """Compile csrc/<name>.cu unless a build of the same source exists.
    Returns (library path, seconds spent, compiler output)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + COMMON_HEADER.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(src)], capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"\n{res.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, res.stdout + res.stderr


def load_library(name):
    """The built csrc/<name>.cu as a ctypes library."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
