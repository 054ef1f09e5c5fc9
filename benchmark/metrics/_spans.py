"""Shared by the span readers: the port's recorded spans
(`phaser_tpu_torch.utils.trace.recorded_spans`), a pass's own.

The --trace 1 window runs under the benchmark's profiler, which is what
makes the port record its spans, so the buffer holds exactly the window's
passes: one `phaser main` span each, in order.  A program without the
recorder gives nothing to read."""

from __future__ import annotations

ROOTS = ("phaser main", "phaser run")


def recorded():
    """The port's recorded spans, or None where it has no recorder."""
    try:
        from phaser_tpu_torch.utils.trace import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def passes(ctx: dict):
    """[((start, end) of the pass in s, its `phaser main` span, the pass's
    spans on that span's thread)], one a pass of the window, or None
    unless every pass has its one `phaser main` span."""
    spans = recorded()
    walls = ctx.get("spans")
    if not spans or not walls:
        return None
    mains = sorted((s for s in spans if s.name == "phaser main"),
                   key=lambda s: s.start_ns)
    if len(mains) != len(walls):
        return None
    return [(wall, main, [s for s in spans if s.run == main.run and
                          s.thread == main.thread])
            for wall, main in zip(walls, mains)]


def glue_children(mine):
    """A pass's unnumbered spans right under `phaser main` or `phaser run`
    (the roots themselves and the numbered stages left out)."""
    roots = {s.id for s in mine if s.name in ROOTS}
    return [s for s in mine if s.parent in roots and s.name not in ROOTS
            and not s.name.startswith("#")]


def covered_s(intervals) -> float:
    """Seconds in the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s >= end:
            total += max(0.0, e - s)
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
