"""#3-#5 (Tracer `#3 connections`, `#4/#5 blocks+phasing`), seconds a
pass."""
from _stages import per_pass


def read(ctx):
    return per_pass(ctx, ["#3 connections", "#4/#5 blocks+phasing"])
