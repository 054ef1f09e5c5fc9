"""The prefetch thread's time blocked on a full queue of decoded windows,
seconds a pass: its `prefetch blocked` spans, summed in each pass (0 where
it never waited)."""
from _stream import per_pass


def read(ctx):
    return per_pass(ctx, "prefetch blocked")
