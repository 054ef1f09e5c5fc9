"""Shared by the stage readers: a group of the engine's stages, the
window's total over its passes."""

from __future__ import annotations


def per_pass(ctx: dict, names) -> object:
    stages = ctx.get("stages")
    if not stages or not all(stages):
        return None
    return sum(sum(s.get(n, 0.0) for n in names) for s in stages) / len(stages)
