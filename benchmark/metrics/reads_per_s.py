"""Input reads of every pass of the window over the window's length (the
pass in flight at its end finishes and counts)."""
from harness.window import rate


def read(ctx):
    return rate(ctx["reads_per_pass"], ctx["t0"], ctx["spans"])
