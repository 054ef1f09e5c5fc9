"""Build-on-demand for the port's compiled code (the counterpart of
phaser_tpu/utils/jaxtune.py: where compiled device code lives).

At first use, every `csrc/*.cu` is compiled by its own `nvcc` for sm_90a
(all started together) and the objects are linked into one shared library
with a plain C interface, `libphaser_kernels.so`, loaded with ctypes.  The
library is rebuilt whenever a source is newer than it.  A missing or
failing `nvcc` raises with the compiler's output: there is no fallback.

The native IO library (`csrc/phaser_io.cc`: BGZF, BAM decode, the exact
mapper, the read packers) is built by `g++` into `libphaser_io.so`.  Test
workers, shard processes and rank processes may ask for either library at
the same moment, so each build runs under a file lock, writes to a
temporary name and renames it into place: no process ever loads a
half-written file.  The IO library is rebuilt when the source is newer or
when the existing file does not load (a library carried over from another
machine); a build or load that still fails raises.

Both libraries go to `_build/` inside the package when that directory can
be created and written, else (a read-only install) to
`$PHASER_TPU_TORCH_CACHE/build`, or `~/.cache/phaser_tpu_torch/build`
without that variable.  The choice is made once per process, at the first
build or load; `BUILD_DIR`, `LIB_PATH` and `IO_LIB_PATH` hold it then, and
a caller may set all three before that to build elsewhere.
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
PKG_BUILD_DIR = os.path.join(_PKG, "_build")
BUILD_DIR: Optional[str] = None     # chosen by build_dir() at first use
LIB_PATH: Optional[str] = None
IO_LIB_PATH: Optional[str] = None
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_dir_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None  # None: nothing was compiled


def _writable_dir(path: str) -> bool:
    try:
        os.makedirs(path, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=path, suffix=".probe")
        os.close(fd)
        os.unlink(probe)
        return True
    except OSError:
        return False


def cache_build_dir() -> str:
    base = os.environ.get("PHASER_TPU_TORCH_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "phaser_tpu_torch")
    return os.path.join(base, "build")


def build_dir() -> str:
    """The build directory (see the module docstring); sets BUILD_DIR,
    LIB_PATH and IO_LIB_PATH where they are unset."""
    global BUILD_DIR, LIB_PATH, IO_LIB_PATH
    with _dir_lock:
        if BUILD_DIR is None:
            BUILD_DIR = PKG_BUILD_DIR if _writable_dir(PKG_BUILD_DIR) \
                else cache_build_dir()
        if LIB_PATH is None:
            LIB_PATH = os.path.join(BUILD_DIR, "libphaser_kernels.so")
        if IO_LIB_PATH is None:
            IO_LIB_PATH = os.path.join(BUILD_DIR, "libphaser_io.so")
        return BUILD_DIR


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
    build_dir()
    if not os.path.exists(LIB_PATH):
        return True
    lib_t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > lib_t for s in _sources())


def _compile_kernels(nvcc: str) -> None:
    """One `nvcc -c` per csrc/*.cu, all started together, then one link
    into LIB_PATH through a temporary name.  The caller holds the lock."""
    global last_build_seconds
    srcs = [s for s in _sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append("nvcc failed (exit %d): %s\n%s"
                              % (p.returncode, " ".join(cmd), out))
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, "libphaser_kernels.so")
        cmd = [nvcc] + NVCC_FLAGS[:2] + ["-shared", "-o", tmp] + objs
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d): %s\n%s%s"
                               % (res.returncode, " ".join(cmd), res.stdout,
                                  res.stderr))
        os.replace(tmp, LIB_PATH)
    last_build_seconds = time.perf_counter() - t0


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH when it is missing or stale (or
    `force`); returns LIB_PATH.  Raises RuntimeError on any failure."""
    build_dir()
    if not force and not is_stale():
        return LIB_PATH
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of phaser_tpu_torch cannot be built")
    with _file_lock(LIB_PATH + ".lock"):
        # another process may have built it while this one waited
        if force or is_stale():
            _compile_kernels(nvcc)
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


_declared = set()


def launch(fn_name: str, argtypes, args) -> None:
    """Calls the launcher `fn_name` of the kernel library (declaring its
    argument types at first use: c_void_p for pointers and the stream) and
    raises when it returns a CUDA error."""
    lib = get_lib()
    fn = getattr(lib, fn_name)
    if fn_name not in _declared:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _declared.add(fn_name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError("%s failed: CUDA error %d (%s)"
                           % (fn_name, err,
                              lib.kernel_error_string(err).decode()))


# ---------------------------------------------------------------------------
# native IO library (host code, g++)
# ---------------------------------------------------------------------------

IO_SRC = os.path.join(CSRC, "phaser_io.cc")
_io_lib: Optional[ctypes.CDLL] = None
last_io_build_seconds: Optional[float] = None  # None: nothing was compiled


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
        build_dir()
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
