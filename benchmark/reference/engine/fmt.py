"""Text formatting helpers that reproduce CPython `str()` semantics.

The reference pipeline writes every output field through `str()` /
`"\t".join(map(str, ...))` (e.g. reference phaser/phaser.py:1857-1859,
2003-2011).  Matching its files byte-for-byte therefore requires matching
CPython float repr ("0.5", "nan", "inf", "2.0" for a true-division int result,
scientific notation thresholds, ...).  We keep values as native Python
ints/floats at the formatting boundary and funnel everything through `str()`.
"""

from __future__ import annotations

import numpy as np


def pystr(x) -> str:
    """`str()` with numpy scalars demoted to native Python scalars first.

    str(np.float64(x)) matches str(float(x)) on current numpy, but we demote
    explicitly so output never depends on the numpy version.
    """
    t = type(x)
    if t is str or t is int or t is float:  # fast path: already native
        return str(x)
    if isinstance(x, np.floating):
        return str(float(x))
    if isinstance(x, np.integer):
        return str(int(x))
    if isinstance(x, np.str_):
        return str(x)
    return str(x)


def list_to_string(xlist, sep: str = ",") -> str:
    """Join with `sep`, formatting each item via pystr.

    Mirrors the reference helper (reference phaser/phaser.py:2003-2011),
    including the empty-list -> "" behavior.
    """
    return sep.join(map(pystr, xlist))


def str_join(joiner: str, xlist) -> str:
    """Mirror of the reference str_join (reference phaser/phaser.py:1857)."""
    return joiner.join(map(pystr, xlist))
