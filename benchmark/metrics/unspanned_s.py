"""A pass's wall time outside every Tracer stage, seconds a pass."""


def read(ctx):
    stages = ctx.get("stages")
    if not stages or not all(stages):
        return None
    walls = [e - s for s, e in ctx["spans"]]
    return sum(w - sum(st.values()) for w, st in zip(walls, stages)) / \
        len(walls)
