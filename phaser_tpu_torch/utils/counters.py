"""Thread-safe increments of the port's module-level counters
(`kernels.alleles.LAUNCHES`, `mapper.dispatch.RELAUNCHES` and the engine
stages' `COUNTS`).  Shard engines run as threads of one process, and
`d[k] += 1` is a read-modify-write that can lose counts across threads;
the CLI and the smoke report and check these counts."""

from __future__ import annotations

import threading

_lock = threading.Lock()


def bump(counts: dict, key: str, n: int = 1) -> None:
    """counts[key] += n, atomically with respect to every other bump."""
    with _lock:
        counts[key] += n
