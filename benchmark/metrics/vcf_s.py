"""#1 VCF filter (Tracer `#1 vcf filter`), seconds a pass."""
from _stages import per_pass


def read(ctx):
    return per_pass(ctx, ["#1 vcf filter"])
