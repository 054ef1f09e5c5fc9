"""Seconds to make the cell's inputs from the seed, or to find them in the
checkout's cache."""


def read(ctx):
    return ctx["inputs_s"]
