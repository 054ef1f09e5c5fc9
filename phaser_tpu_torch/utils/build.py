"""Build-on-demand for the port's compiled code (the counterpart of
phaser_tpu/utils/jaxtune.py: where compiled device code lives).

At first use, every `csrc/*.cu` is compiled by `nvcc` for sm_90a into one
shared library with a plain C interface, `_build/libphaser_kernels.so`,
and loaded with ctypes.  The library is rebuilt whenever a source is newer
than it.  A missing or failing `nvcc` raises with the compiler's output:
there is no fallback.

The native IO library (`csrc/phaser_io.cc`: BGZF, BAM decode, the exact
mapper, the read packers) is built the same way by `g++` into
`_build/libphaser_io.so`.  Test workers and shard processes may ask for it
at the same moment, so the build runs under a file lock, writes to a
temporary name and renames it into place: no process ever loads a
half-written file.  It is rebuilt when the source is newer or when the
existing file does not load (a library carried over from another
machine); a build or load that still fails raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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


# ---------------------------------------------------------------------------
# native IO library (host code, g++)
# ---------------------------------------------------------------------------

IO_SRC = os.path.join(CSRC, "phaser_io.cc")
IO_LIB_PATH = os.path.join(BUILD_DIR, "libphaser_io.so")
_io_lib: Optional[ctypes.CDLL] = None
last_io_build_seconds: Optional[float] = None  # None: nothing was compiled


@contextlib.contextmanager
def _file_lock(path: str):
    """Exclusive advisory lock across processes (and threads: each entry
    opens its own descriptor)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile_io() -> None:
    """g++ IO_SRC -> IO_LIB_PATH through a temporary name.  The caller holds
    the file lock."""
    global last_io_build_seconds
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, IO_SRC, "-lz", "-lpthread"]
    # libdeflate (2-3x faster BGZF inflate than zlib) when present
    for libdir in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
                   "/usr/lib", "/usr/local/lib"):
        if os.path.exists(os.path.join(libdir, "libdeflate.so")):
            cmd.append("-ldeflate")
            break
    t0 = time.perf_counter()
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if res.returncode != 0 and "-ldeflate" in cmd:
                cmd.remove("-ldeflate")
                cmd.insert(1, "-DPHASER_NO_LIBDEFLATE")
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError("building the native IO library failed: %s: %s"
                               % (" ".join(cmd), e)) from e
        if res.returncode != 0:
            raise RuntimeError("g++ failed (exit %d): %s\n%s%s"
                               % (res.returncode, " ".join(cmd), res.stdout,
                                  res.stderr))
        os.replace(tmp, IO_LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_io_build_seconds = time.perf_counter() - t0


def _io_is_stale() -> bool:
    return (not os.path.exists(IO_LIB_PATH) or
            os.path.getmtime(IO_LIB_PATH) < os.path.getmtime(IO_SRC))


def get_io_lib() -> ctypes.CDLL:
    """The loaded native IO library, built first when it is missing, older
    than its source, or does not load.  Raises RuntimeError on failure."""
    global _io_lib
    with _lock:
        if _io_lib is not None:
            return _io_lib
        with _file_lock(IO_LIB_PATH + ".lock"):
            if _io_is_stale():
                _compile_io()
            try:
                lib = ctypes.CDLL(IO_LIB_PATH)
            except OSError:
                # built elsewhere (other CPU, other libraries): build here
                _compile_io()
                try:
                    lib = ctypes.CDLL(IO_LIB_PATH)
                except OSError as e:
                    raise RuntimeError(
                        "the native IO library %s was built but does not "
                        "load: %s" % (IO_LIB_PATH, e)) from e
        _io_lib = lib
        return _io_lib
