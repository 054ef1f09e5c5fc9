"""Share of the reads offered to the card that #2's pre-filter passes to
the ragged join, in percent: the dispatcher's `rows_kept` over `rows_in`,
their increase inside the window's `#2 allele assignment` spans."""
from _spans import passes


def read(ctx):
    ps = passes(ctx)
    if ps is None:
        return None
    rows_in = rows_kept = 0
    for _, _, mine in ps:
        for s in mine:
            if s.name == "#2 allele assignment" and s.counts:
                rows_in += s.counts.get("rows_in", 0)
                rows_kept += s.counts.get("rows_kept", 0)
    return 100.0 * rows_kept / rows_in if rows_in else None
