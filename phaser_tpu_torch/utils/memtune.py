"""Host memory tuning for lazily-backed VMs.

Some virtual machines serve first-touch page faults of private anonymous
memory remotely (~0.5 ms/page — 3 orders of magnitude over local zero-fill),
and glibc returns large freed blocks to the OS, so every big numpy temporary
pays the full fault cost again.  `setup()`:

  1. mallopt(M_TRIM_THRESHOLD, max) + mallopt(M_MMAP_MAX, 0): big allocations
     come from the brk heap and freed pages stay in the arena for reuse
  2. optionally pre-faults a working-set-sized arena with parallel C threads
     (faults pipeline across threads) and frees it back into the arena

After setup, steady-state large-array numpy work runs at normal speed.
No-ops cleanly on normal machines.
"""

from __future__ import annotations

import ctypes
import os

_done = False
M_TRIM_THRESHOLD = -1
M_MMAP_MAX = -4


def bgzf_uncompressed_size(path: str) -> int:
    """Total uncompressed size of a BGZF file via the native block scan
    (cheap: reads headers/trailers only). -1 when unavailable."""
    try:
        from ..io import native as native_mod
        lib = native_mod.get_lib()
        if lib is None:
            return -1
        with open(path, "rb") as fh:
            raw = fh.read()
        return int(lib.bgzf_total_size(raw, len(raw)))
    except Exception:
        return -1


_prefaulted_mb = 0
_prefault_lock = None


def setup(prefault_mb: int = 0, n_threads: int = 0,
          background: bool = False) -> None:
    global _done, _prefaulted_mb, _prefault_lock
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        if not _done:
            libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)
            libc.mallopt(M_MMAP_MAX, 0)
            _done = True
    except OSError:
        return
    env_mb = os.environ.get("PHASER_TPU_PREFAULT_MB")
    if env_mb is not None:
        prefault_mb = int(env_mb)
    # once the arena has been grown to this size, later runs in the same
    # process reuse the already-resident pages — re-touching them is pure
    # fixed cost (~0.1 s/GB on the engine's critical path)
    if prefault_mb <= _prefaulted_mb:
        return
    if prefault_mb > 0:
        from ..io import native as native_mod
        lib = native_mod.get_lib()
        if lib is not None:
            if n_threads <= 0:
                n_threads = min(os.cpu_count() or 1, 16)
            lib.prefault_alloc.restype = ctypes.c_void_p
            lib.prefault_alloc.argtypes = [ctypes.c_int64, ctypes.c_int]
            lib.prefault_free.argtypes = [ctypes.c_void_p]
            _prefaulted_mb = prefault_mb

            def _touch():
                p = lib.prefault_alloc(prefault_mb * 1024 * 1024, n_threads)
                if p:
                    lib.prefault_free(p)

            if background:
                # overlap the fault storm with the engine's opening stages
                # (VCF filter + BAM decode): the faults only need to land
                # before the big mapper temporaries allocate
                import threading
                threading.Thread(target=_touch, daemon=True,
                                 name="phaser-prefault").start()
            else:
                _touch()
