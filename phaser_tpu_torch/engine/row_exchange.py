"""Compact mapper-row bundles for cross-shard exchange (position sharding).

Under a position-range shard plan, a shard that decoded reads of a contig
it does not own ships the contig's mapper ROWS (hits) to the owner — not
the reads: rows are orders of magnitude smaller (one per read x variant
overlap).  The reference's analogue is the parent process ingesting every
fork worker's mapping result file (reference phaser/phaser.py:556-586).

A bundle carries exactly what the accumulation stage
(engine.hits.build_contig_rows) reads from a (chunk, hits) pair:
per-row read name, variant index (into the FULL per-contig table — shard
tables are identical), allele code/string, and the AS score fields used by
the global quantile cutoff.  The owner reconstructs a minimal chunk shim
whose read_idx is the identity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..io.bam import NameView
from ..mapper.host import ContigHits


class RowChunk:
    """Minimal chunk interface for exchanged rows: one 'read' per row."""

    __slots__ = ("names", "as_score", "has_as")

    def __init__(self, names: NameView, as_score: np.ndarray,
                 has_as: np.ndarray):
        self.names = names
        self.as_score = as_score
        self.has_as = has_as

    def __len__(self) -> int:
        return len(self.as_score)


def bundle_entry(chunk, hits: ContigHits) -> Tuple:
    """(name_blob, name_off, var_idx, allele_code, allele_strs,
    as_score, has_as) — plain pickleable arrays."""
    ri = hits.read_idx
    n = len(ri)
    nm = chunk.names
    if isinstance(nm, NameView):
        nv = nm.gather(np.asarray(ri, np.int64))
        blob, off = nv.blob, nv.off
    else:
        parts = [nm[int(i)] for i in ri]
        off = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in parts], out=off[1:])
        blob = b"".join(parts)
    return (blob, off,
            np.asarray(hits.var_idx, np.int64),
            np.asarray(hits.allele_code, np.int16),
            dict(hits.allele_strs),
            np.asarray(chunk.as_score)[ri],
            np.asarray(chunk.has_as)[ri])


def unbundle_entry(bundle: Tuple) -> Tuple[RowChunk, ContigHits]:
    blob, off, var_idx, code, strs, as_score, has_as = bundle
    n = len(var_idx)
    chunk = RowChunk(NameView(blob, off), as_score, has_as)
    hits = ContigHits(np.arange(n, dtype=np.int64), var_idx, code,
                      dict(strs))
    return chunk, hits
