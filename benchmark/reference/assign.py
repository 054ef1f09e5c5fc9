"""Allele assignment (#2) from the generator's read arrays.

phASER's mapper (read_variant_map.py): reads are kept by their flags and
MAPQ; a base with quality under BASEQ reads N; a SNP is observed by a read
whose aligned (M, =, X) block covers it, as that read's base there; an N
is dropped.  One row for each (read, SNP), in read order and then in the
table's order.  Written over the CIGAR's aligned blocks with numpy; the
generator's reads hold S, M and N operations only, and any other operation
is refused here."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

OP_M, OP_EQ, OP_X, OP_N, OP_S = 0, 7, 8, 3, 4
F_PROPER, F_UNMAPPED, F_DUP = 0x2, 0x4, 0x400
_READ = np.zeros(16, bool)
_READ[[OP_M, OP_S, OP_EQ, OP_X]] = True
_REF = np.zeros(16, bool)
_REF[[OP_M, OP_N, OP_EQ, OP_X]] = True
_ALIGNED = np.zeros(16, bool)
_ALIGNED[[OP_M, OP_EQ, OP_X]] = True


@dataclass
class ContigHits:
    read_idx: np.ndarray
    var_idx: np.ndarray
    allele_code: np.ndarray
    allele_strs: Dict[int, str] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.read_idx)


class NameView:
    """Read names as one blob and offsets."""

    def __init__(self, blob: bytes, off: np.ndarray):
        self.blob = blob
        self.off = off


@dataclass
class Chunk:
    """The kept reads of one BAM, as the later stages read them."""
    names: NameView
    as_score: np.ndarray
    has_as: np.ndarray


def kept(rs, mapq_min: int, paired: bool, remove_dups: bool) -> np.ndarray:
    excl = F_UNMAPPED | (F_DUP if remove_dups else 0)
    req = F_PROPER if paired else 0
    return np.flatnonzero(((rs.flag & excl) == 0) & ((rs.flag & req) == req)
                          & (rs.mapq >= mapq_min))


def chunk_of(rs, keep: np.ndarray) -> Chunk:
    names = rs.names()
    sel = [names[i] for i in keep.tolist()]
    off = np.zeros(len(sel) + 1, np.int64)
    np.cumsum([len(s) for s in sel], out=off[1:])
    return Chunk(NameView(b"".join(sel), off),
                 rs.as_score[keep].astype(np.int64),
                 np.ones(len(keep), bool))


def aligned_hits(rs, keep: np.ndarray, snp_pos: np.ndarray):
    """(read, var, query offset) of every SNP under an aligned base of a
    kept read, whatever its quality."""
    ops_per = np.diff(rs.cig_off)[keep]
    op_idx = np.repeat(rs.cig_off[:-1][keep], ops_per) + (
        np.arange(int(ops_per.sum())) - np.repeat(np.cumsum(ops_per) - ops_per,
                                                  ops_per))
    ops = rs.cigar[op_idx]
    code = (ops & 0xF).astype(np.int64)
    if not np.isin(code, [OP_M, OP_N, OP_S, OP_EQ, OP_X]).all():
        raise ValueError("the reference walks S, M, =, X and N operations "
                         "only")
    ln = (ops >> 4).astype(np.int64)
    read = np.repeat(np.arange(len(keep)), ops_per)
    first = np.repeat(np.cumsum(ops_per) - ops_per, ops_per)

    def before(v):
        c = np.cumsum(v)
        return c - v - (c[first] - v[first])
    q0 = before(np.where(_READ[code], ln, 0))
    g0 = rs.pos[keep][read] + before(np.where(_REF[code], ln, 0))
    a = _ALIGNED[code]
    read, q0, g0, ln = read[a], q0[a], g0[a], ln[a]
    # SNPs (1-based) in [g0 + 1, g0 + ln]
    lo = np.searchsorted(snp_pos, g0 + 1, side="left")
    hi = np.searchsorted(snp_pos, g0 + ln, side="right")
    k = hi - lo
    r = np.repeat(read, k)
    v = np.repeat(lo, k) + (np.arange(int(k.sum())) -
                            np.repeat(np.cumsum(k) - k, k))
    q = np.repeat(q0, k) + (snp_pos[v] - 1 - np.repeat(g0, k))
    order = np.lexsort((v, r))
    return r[order], v[order], q[order]


def assign(rs, keep: np.ndarray, vt, baseq: int) -> ContigHits:
    """The rows of the kept reads `keep` against the variant table."""
    order = np.argsort(vt.pos, kind="stable")
    r, vs, q = aligned_hits(rs, keep, vt.pos[order])
    v = order[vs]
    base = rs.seq[keep[r], q].astype(np.int16)
    base[rs.qual[keep[r], q] < baseq] = 15
    ok = base != 15
    r, v, base = r[ok], v[ok], base[ok]
    # rows in read order, then the table's order
    o = np.lexsort((v, r))
    return ContigHits(r[o].astype(np.int64), v[o].astype(np.int64), base[o])


def join_work(rs, keep: np.ndarray, vt, baseq: int) -> dict:
    """What the ragged join must read and write for these reads: the rows
    with a SNP under an aligned base and their CIGAR operations, the table
    entries they hit, those hits, and the hits it emits (quality at least
    BASEQ)."""
    order = np.argsort(vt.pos, kind="stable")
    r, v, q = aligned_hits(rs, keep, vt.pos[order])
    rows = np.unique(r)
    ops = int(np.diff(rs.cig_off)[keep[rows]].sum())
    emitted = int((rs.qual[keep[r], q] >= baseq).sum())
    return {"rows": len(rows), "ops": ops, "entries": len(np.unique(v)),
            "hits": len(r), "emitted": emitted}
