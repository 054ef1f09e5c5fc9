"""#6-#7 outputs (Tracer `#6 outputs`, `#7 vcf write`), seconds a pass."""
from _stages import per_pass


def read(ctx):
    return per_pass(ctx, ["#6 outputs", "#7 vcf write"])
