"""BAI and tabix indexes of the benchmark's inputs (SAM/BAM specification,
section 5.2; tabix, section 5.3): the 37,449 bins of 16 KiB leaves over
five levels and the 16 KiB linear index, built with numpy from every
record's reference span and virtual offsets, in file order."""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

MIN_SHIFT = 14
LEVEL_START = (0, 1, 9, 73, 585, 4681)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The smallest bin holding each [beg, end) (0-based), vectorised."""
    beg = np.asarray(beg, np.int64)
    last = np.maximum(np.asarray(end, np.int64) - 1, beg)
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for lvl in range(5, 0, -1):
        shift = MIN_SHIFT + 3 * (5 - lvl)
        same = ~done & ((beg >> shift) == (last >> shift))
        out[same] = LEVEL_START[lvl] + (beg[same] >> shift)
        done |= same
    return out


def ref_index(beg: np.ndarray, end: np.ndarray, vbeg: np.ndarray,
              vend: np.ndarray) -> bytes:
    """One reference's bins, chunks and linear index, as the index file
    lays them out; the records are in file order."""
    n = len(beg)
    if n == 0:
        return struct.pack("<ii", 0, 0)
    bins = reg2bin(beg, end)
    # chunks: runs of records in one bin that follow each other in the
    # file, then grouped by bin in file order
    order = np.lexsort((np.arange(n), bins))
    b_s, vb_s, ve_s = bins[order], vbeg[order], vend[order]
    new = np.ones(n, bool)
    new[1:] = (b_s[1:] != b_s[:-1]) | (vb_s[1:] != ve_s[:-1])
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], n) - 1
    c_bin, c_beg, c_end = b_s[starts], vb_s[starts], ve_s[ends]
    out: List[bytes] = []
    ubins, first = np.unique(c_bin, return_index=True)
    stops = np.append(first[1:], len(c_bin))
    out.append(struct.pack("<i", len(ubins)))
    for b, s, e in zip(ubins.tolist(), first.tolist(), stops.tolist()):
        out.append(struct.pack("<Ii", b, e - s))
        pairs = np.empty((e - s, 2), "<u8")
        pairs[:, 0] = c_beg[s:e]
        pairs[:, 1] = c_end[s:e]
        out.append(pairs.tobytes())
    # linear index: each 16 KiB window holds the least virtual offset of
    # the records that overlap it; empty windows take the one before
    w0 = np.asarray(beg, np.int64) >> MIN_SHIFT
    w1 = np.maximum(np.asarray(end, np.int64) - 1, beg) >> MIN_SHIFT
    n_win = int(w1.max()) + 1
    span = w1 - w0 + 1
    rec = np.repeat(np.arange(n), span)
    win = np.repeat(w0, span) + (np.arange(int(span.sum()))
                                 - np.repeat(np.cumsum(span) - span, span))
    big = np.iinfo(np.int64).max
    lin = np.full(n_win, big, np.int64)
    np.minimum.at(lin, win, np.asarray(vbeg, np.int64)[rec])
    lin[lin == big] = 0
    prev = np.maximum.accumulate(np.where(lin > 0, np.arange(n_win), -1))
    lin = np.where(prev >= 0, lin[np.maximum(prev, 0)], 0)
    out.append(struct.pack("<i", n_win))
    out.append(lin.astype("<u8").tobytes())
    return b"".join(out)


def bai(n_refs: int, tid: int, beg, end, vbeg, vend) -> bytes:
    """A BAI whose records all lie on reference `tid` of `n_refs`."""
    parts = [b"BAI\x01", struct.pack("<i", n_refs)]
    for t in range(n_refs):
        parts.append(ref_index(beg, end, vbeg, vend) if t == tid
                     else struct.pack("<ii", 0, 0))
    parts.append(struct.pack("<Q", 0))
    return b"".join(parts)


def tbi(names: Sequence[str], tid: int, beg, end, vbeg, vend) -> bytes:
    """An uncompressed tabix index of a VCF (format 2: columns 1, 2 and
    the REF length, meta `#`) whose records lie on `names[tid]`."""
    nm = b"".join(s.encode() + b"\x00" for s in names)
    parts = [b"TBI\x01", struct.pack("<i", len(names)),
             struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0),
             struct.pack("<i", len(nm)), nm]
    for t in range(len(names)):
        parts.append(ref_index(beg, end, vbeg, vend) if t == tid
                     else struct.pack("<ii", 0, 0))
    parts.append(struct.pack("<Q", 0))
    return b"".join(parts)
