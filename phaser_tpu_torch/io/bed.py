"""BED interval masks (blacklists) — native replacement for bedtools intersect.

The reference shells out to `bedtools intersect -v` to drop blacklisted
variants (reference phaser/phaser.py:220) and `bedtools intersect` to
list haplo-count-blacklisted positions (:234).  Overlap semantics: a VCF
record covers [pos-1, pos-1+len(ref)) 0-based half-open; any >=1 bp overlap
with any interval counts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class IntervalSet:
    """Per-chromosome interval set with O(log n) any-overlap queries."""

    def __init__(self, by_chrom: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self._data = {}
        for chrom, (starts, ends) in by_chrom.items():
            order = np.argsort(starts, kind="stable")
            s = np.asarray(starts)[order]
            e = np.asarray(ends)[order]
            self._data[chrom] = (s, np.maximum.accumulate(e))

    @classmethod
    def from_bed(cls, path: str) -> "IntervalSet":
        by_chrom: Dict[str, Tuple[list, list]] = {}
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                cols = line.split("\t")
                chrom = cols[0]
                s, e = int(cols[1]), int(cols[2])
                by_chrom.setdefault(chrom, ([], []))
                by_chrom[chrom][0].append(s)
                by_chrom[chrom][1].append(e)
        return cls({c: (np.asarray(v[0], np.int64), np.asarray(v[1], np.int64))
                    for c, v in by_chrom.items()})

    def overlaps(self, chrom: str, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """Vectorized: True where [start, end) overlaps any interval on chrom."""
        starts = np.asarray(starts)
        if chrom not in self._data:
            return np.zeros(len(starts), bool)
        s, cummax_e = self._data[chrom]
        idx = np.searchsorted(s, np.asarray(ends) - 1, side="right")
        out = np.zeros(len(starts), bool)
        nz = idx > 0
        out[nz] = cummax_e[idx[nz] - 1] > starts[nz]
        return out
