"""The measured window: whole passes back to back.

Passes start until `seconds` have gone by since the window opened; the pass
in flight then finishes and counts.  The rate is the work of every pass
over the time from the window's start to the end of its last pass, so no
pass is cut off and none is left out."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def run_window(one_pass: Callable[[int], None], seconds: float,
               clock: Callable[[], float] = time.perf_counter
               ) -> Tuple[float, List[Tuple[float, float]]]:
    """(window start, [(start, end) of each pass]) on `clock`."""
    t0 = clock()
    spans = []
    while True:
        s = clock()
        one_pass(len(spans))
        e = clock()
        spans.append((s, e))
        if e - t0 >= seconds:
            return t0, spans


def rate(work_per_pass: float, t0: float, spans) -> float:
    """Work of all passes over the window's length."""
    return work_per_pass * len(spans) / (spans[-1][1] - t0)
