"""The ragged join's share of its roofline, in percent: the least time
the bytes of the window's launches need at the card's memory rate, over
the kernel's time in the trace.  The bytes are counted over the work
these inputs need, which the reference counts (harness/roofline.py)."""
from harness.roofline import bound_seconds, ragged_join_bytes


def read(ctx):
    tr = ctx.get("trace")
    work = ctx.get("join_work")
    if not tr or not work:
        return None
    t = sum(float(e.get("dur", 0)) for e in tr["events"]
            if "ragged_join_kernel" in e["name"]) / 1e6
    if t <= 0:
        return None
    need = sum(ragged_join_bytes(**w) for w in work) * len(ctx["spans"])
    return 100.0 * bound_seconds(need) / t
