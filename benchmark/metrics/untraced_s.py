"""What no span covers, seconds a pass: a pass's wall time less the union
of its spans other than `phaser main` and `phaser run`."""
from _spans import ROOTS, covered_s, passes


def read(ctx):
    ps = passes(ctx)
    if ps is None:
        return None
    total = 0.0
    for (w0, w1), _, mine in ps:
        total += (w1 - w0) - covered_s(
            (max(s.start_ns / 1e9, w0), min(s.end_ns / 1e9, w1))
            for s in mine if s.name not in ROOTS)
    return total / len(ps)
