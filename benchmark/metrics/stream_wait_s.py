"""The main thread's waits for a streamed window, seconds a pass: the
`#2 bam decode` spans that count `stream_waits` (a whole decode's counts
nothing), summed in each pass."""
from _stream import per_pass


def read(ctx):
    return per_pass(ctx, "#2 bam decode",
                    lambda s: bool(s.counts and s.counts.get("stream_waits")))
