"""Shared by the streaming readers: the spans of each pass's run on every
thread (the prefetch thread's `decode window` and `prefetch blocked`
spans, the main thread's waits for a window), seconds a pass."""

from __future__ import annotations

import _spans


def per_pass(ctx: dict, name: str, keep=None):
    """Seconds a pass of the spans named `name` (those `keep` takes) in
    the window's passes, or None unless a pass decoded a stream with the
    stream's counters (a `decode window` span in its run that counted
    reads and bytes: a program without them gives nothing)."""
    ps = _spans.passes(ctx)
    if ps is None:
        return None
    runs = {main.run for _, main, _ in ps}
    spans = [s for s in _spans.recorded() if s.run in runs]
    if not any(s.name == "decode window" and s.counts for s in spans):
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == name and (keep is None or keep(s))
               ) / 1e9 / len(ps)
