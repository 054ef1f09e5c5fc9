"""The engine's glue, seconds a pass: the unnumbered spans right under
`phaser main` and `phaser run` (the CLI, input sizes, the VCF header, the
variant tables, the decode plans, the read filters, the AS cutoffs, the
entry offsets, the noise, the table writes, the rsid lookup, the summary),
summed in each pass."""
from _spans import glue_children, passes


def read(ctx):
    ps = passes(ctx)
    if ps is None:
        return None
    return sum(sum(s.end_ns - s.start_ns for s in glue_children(mine))
               for _, _, mine in ps) / 1e9 / len(ps)
