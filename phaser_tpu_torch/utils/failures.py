"""Structured failure reporting.

The reference's failure model is fail-fast prints: fatal_error -> message +
sys.exit(1) (reference phaser/phaser.py:2032-2034) and shell pipelines
under `set -euo pipefail` (:221, :1347). phaser_tpu keeps the fail-fast
contract but records WHAT failed as a machine-readable JSON record next to
the output prefix (`<o>.failure.json`): tool, version, pipeline stage,
exception chain, traceback, argv, and resource state — enough for a batch
scheduler (the GTEx-scale use case runs thousands of samples) to triage
failures without scraping logs.

Pipeline code marks the active stage with `failure_stage(...)`; the CLI
entry points call `write_failure_record` from their exception handler.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import json
import os
import platform
import resource
import sys
import traceback
from typing import Optional

_current_stage: contextvars.ContextVar = contextvars.ContextVar(
    "phaser_tpu_stage", default=None)


@contextlib.contextmanager
def failure_stage(name: str):
    """Mark `name` as the active pipeline stage for failure records."""
    token = _current_stage.set(name)
    try:
        yield
    finally:
        _current_stage.reset(token)


def current_stage() -> Optional[str]:
    return _current_stage.get()


def _exception_chain(exc: BaseException) -> list:
    chain = []
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        chain.append({"type": type(e).__name__, "message": str(e)})
        e = e.__cause__ or e.__context__
    return chain


def write_failure_record(out_prefix: str, tool: str,
                         exc: BaseException, argv=None) -> Optional[str]:
    """Write `<out_prefix>.failure.json`; returns the path (None if even
    that failed — failure reporting must never mask the original error)."""
    try:
        from ..version import __version__
    except Exception:
        __version__ = "unknown"
    record = {
        "tool": tool,
        "version": __version__,
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "stage": current_stage(),
        "exceptions": _exception_chain(exc),
        "traceback": traceback.format_exception(type(exc), exc,
                                                exc.__traceback__)[-25:],
        "argv": list(argv if argv is not None else sys.argv[1:]),
        "cwd": os.getcwd(),
        "pid": os.getpid(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
    }
    path = out_prefix + ".failure.json"
    try:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        return path
    except OSError:
        return None


def clear_failure_record(out_prefix: str) -> None:
    """Remove a stale record from a previous failed run on success."""
    try:
        os.unlink(out_prefix + ".failure.json")
    except OSError:
        pass
