"""BAM decode (Tracer `#2 bam decode`), seconds a pass."""
from _stages import per_pass


def read(ctx):
    return per_pass(ctx, ["#2 bam decode"])
