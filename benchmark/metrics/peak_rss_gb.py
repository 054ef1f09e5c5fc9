"""The process's peak resident memory (ru_maxrss) at the window's end,
before the reference runs; 1e9 bytes."""


def read(ctx):
    return ctx["peak_rss_bytes"] / 1e9
