"""Streaming decode, seconds a pass: the prefetch thread's `decode window`
spans (inflate and parse of each window of a BAM over the streaming
threshold), summed in each pass."""
from _stream import per_pass


def read(ctx):
    return per_pass(ctx, "decode window")
