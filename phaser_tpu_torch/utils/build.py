"""Build-on-demand for the port's CUDA kernels (the counterpart of
phaser_tpu/utils/jaxtune.py: where compiled device code lives).

At first use, every `csrc/*.cu` is compiled by `nvcc` for sm_90a into one
shared library with a plain C interface, `_build/libphaser_kernels.so`,
and loaded with ctypes.  The library is rebuilt whenever a source is newer
than it.  A missing or failing `nvcc` raises with the compiler's output:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libphaser_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None  # None: nothing was compiled


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> Optional[str]:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    return shutil.which("nvcc")


def is_stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > lib_t for s in _sources())


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH when it is missing or stale (or
    `force`); returns LIB_PATH.  Raises RuntimeError on any failure."""
    global last_build_seconds
    if not force and not is_stale():
        return LIB_PATH
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of phaser_tpu_torch cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    srcs = [s for s in _sources() if s.endswith(".cu")]
    cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp] + srcs
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d): %s\n%s%s"
                               % (res.returncode, " ".join(cmd),
                                  res.stdout, res.stderr))
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build_seconds = time.perf_counter() - t0
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib
