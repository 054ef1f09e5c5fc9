"""#2 allele assignment (Tracer `#2 allele assignment`, `#2 hit resolve`,
`#2 accumulate`), seconds a pass."""
from _stages import per_pass


def read(ctx):
    return per_pass(ctx, ["#2 allele assignment", "#2 hit resolve",
                          "#2 accumulate"])
