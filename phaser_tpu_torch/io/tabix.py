"""Tabix (.tbi) index writer/reader — native replacement for the `tabix` binary.

The reference pipeline requires tabix-indexed VCFs and shells out to create
them (reference phaser/phaser.py:124-131, 1851-1853); phaser_pop/annotate
use pysam.Tabixfile region fetches (reference phaser_pop/phaser_cis_var.py:227).
We implement the TBI format (htslib spec) directly: UCSC R-tree binning with
min shift 14 and 5 levels, plus the 16 KiB linear index.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from . import bgzf

TBI_MAGIC = b"TBI\x01"

# Preset formats (conf.format)
FMT_GENERIC = 0
FMT_SAM = 1
FMT_VCF = 2
FLAG_UCSC = 0x10000  # coordinates are 0-based half-open

_BIN_OFFSETS = (0, 1, 9, 73, 585, 4681)  # cumulative bins per level
_MIN_SHIFT = 14
_N_LVLS = 5


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin fully containing [beg, end) (0-based half-open)."""
    end -= 1
    for lvl in range(_N_LVLS, 0, -1):
        shift = _MIN_SHIFT + 3 * (_N_LVLS - lvl)
        if beg >> shift == end >> shift:
            return _BIN_OFFSETS[lvl] + (beg >> shift)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    if beg >= end:
        return []
    end -= 1
    bins = [0]
    for lvl in range(1, _N_LVLS + 1):
        shift = _MIN_SHIFT + 3 * (_N_LVLS - lvl)
        bins.extend(range(_BIN_OFFSETS[lvl] + (beg >> shift),
                          _BIN_OFFSETS[lvl] + (end >> shift) + 1))
    return bins


class TabixIndexBuilder:
    """Accumulates (tid, beg0, end0, voff_start, voff_end) records in file order."""

    def __init__(self, names: Sequence[str], fmt: int = FMT_VCF,
                 col_seq: int = 1, col_beg: int = 2, col_end: int = 2,
                 meta_char: str = "#", skip: int = 0):
        self.names = list(names)
        self.conf = (fmt, col_seq, col_beg, col_end, ord(meta_char), skip)
        # per ref: bin -> list of [cnk_beg, cnk_end]
        self._bins: List[Dict[int, List[List[int]]]] = [dict() for _ in names]
        self._linear: List[List[int]] = [[] for _ in names]
        self.n_no_coor = 0

    def add(self, tid: int, beg0: int, end0: int, voff_beg: int, voff_end: int) -> None:
        if tid < 0:
            self.n_no_coor += 1
            return
        b = reg2bin(beg0, end0)
        chunks = self._bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1][1] = voff_end  # coalesce adjacent
        else:
            chunks.append([voff_beg, voff_end])
        lin = self._linear[tid]
        w_beg, w_end = beg0 >> _MIN_SHIFT, max(beg0, end0 - 1) >> _MIN_SHIFT
        if len(lin) <= w_end:
            lin.extend([0] * (w_end + 1 - len(lin)))
        for w in range(w_beg, w_end + 1):
            if lin[w] == 0:
                lin[w] = voff_beg

    def tobytes(self) -> bytes:
        out = [TBI_MAGIC, struct.pack("<i", len(self.names))]
        out.append(struct.pack("<6i", *self.conf))
        nm = b"".join(n.encode() + b"\x00" for n in self.names)
        out.append(struct.pack("<i", len(nm)))
        out.append(nm)
        for tid in range(len(self.names)):
            bins = self._bins[tid]
            out.append(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                out.append(struct.pack("<Ii", b, len(chunks)))
                for cb, ce in chunks:
                    out.append(struct.pack("<QQ", cb, ce))
            lin = self._linear[tid]
            # backfill zero windows with the previous voff (htslib convention)
            prev = 0
            for i, v in enumerate(lin):
                if v == 0:
                    lin[i] = prev
                else:
                    prev = v
            out.append(struct.pack("<i", len(lin)))
            out.append(struct.pack("<%dQ" % len(lin), *lin) if lin else b"")
        out.append(struct.pack("<Q", self.n_no_coor))
        return b"".join(out)

    def write(self, path: str) -> None:
        bgzf.compress_to_path(self.tobytes(), path)


def build_vcf_index(vcf_gz_path: str, tbi_path: Optional[str] = None) -> None:
    """Index an existing bgzipped VCF (equivalent of `tabix -p vcf f.vcf.gz`)."""
    build_text_index(vcf_gz_path, tbi_path, preset="vcf")


def build_text_index(vcf_gz_path: str, tbi_path: Optional[str] = None,
                     preset: str = "vcf", col_seq: int = 1, col_beg: int = 2,
                     col_end: int = 2) -> None:
    """Index a bgzipped, position-sorted text file (VCF or generic TSV,
    e.g. a CADD whole_genome_SNVs.tsv.gz)."""
    import bisect

    raw = open(vcf_gz_path, "rb").read()
    offs: List[int] = []
    payload_lens: List[int] = []
    payloads: List[bytes] = []
    off = 0
    while off < len(raw):
        payload, bsize = bgzf.decompress_block(raw, off)
        offs.append(off)
        payload_lens.append(len(payload))
        payloads.append(payload)
        off += bsize
    data = b"".join(payloads)
    # uncompressed end offset of each block, for offset -> voff translation
    uends: List[int] = []
    acc = 0
    for n in payload_lens:
        acc += n
        uends.append(acc)

    def uoff2voff(u: int) -> int:
        bi = bisect.bisect_right(uends, u)
        if bi >= len(offs):
            bi = len(offs) - 1
        ustart = uends[bi] - payload_lens[bi]
        return (offs[bi] << 16) | (u - ustart)

    names: List[str] = []
    name_idx: Dict[str, int] = {}
    is_vcf = preset == "vcf"
    b = TabixIndexBuilder(names, fmt=FMT_VCF if is_vcf else FMT_GENERIC,
                          col_seq=col_seq, col_beg=col_beg, col_end=col_end)
    pos = 0
    n_total = len(data)
    while pos < n_total:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n_total
        line = data[pos:nl]
        if line and not line.startswith(b"#"):
            cols = line.split(b"\t")
            if is_vcf:
                chrom = cols[0].decode()
                p1 = int(cols[1])
                ref = cols[3] if len(cols) > 3 else b"N"
                beg0, end0 = p1 - 1, p1 - 1 + len(ref)
            else:
                chrom = cols[col_seq - 1].decode()
                beg0 = int(cols[col_beg - 1]) - 1
                end0 = int(cols[col_end - 1])
            if chrom not in name_idx:
                name_idx[chrom] = len(names)
                names.append(chrom)
                b._bins.append(dict())
                b._linear.append([])
            b.add(name_idx[chrom], beg0, end0, uoff2voff(pos),
                  uoff2voff(nl + 1))
        pos = nl + 1
    b.names = names
    b.write(tbi_path or vcf_gz_path + ".tbi")


def vcf_index_from_text(text, csizes, usizes) -> bytes:
    """The .tbi, uncompressed, that build_vcf_index writes for a bgzipped
    VCF, from the VCF's text (a uint8 array) and the compressed and payload
    size of each of its blocks, the EOF block last (`bgzf.compress_sized`),
    without reading the file back: the same names, bins, chunks and linear
    index, byte for byte.  Needs the native library."""
    import numpy as np

    tid, beg, end, ustart, uend, names = _vcf_records(text)
    csizes = np.asarray(csizes, np.int64)
    usizes = np.asarray(usizes, np.int64)
    coff = np.cumsum(csizes) - csizes
    uends = np.cumsum(usizes)

    def uoff2voff(u):
        # build_text_index's bisect: a block's end maps to the next block
        bi = np.minimum(np.searchsorted(uends, u, side="right"),
                        len(uends) - 1)
        return (coff[bi] << 16) | (u - (uends[bi] - usizes[bi]))

    vbeg, vend = uoff2voff(ustart), uoff2voff(uend)
    b = TabixIndexBuilder(names)
    if not len(beg) or beg.min() < 0:
        # (a POS of 0 sends the builder's window loop to negative windows:
        # replay it record by record)
        for rec in zip(tid.tolist(), beg.tolist(), end.tolist(),
                       vbeg.tolist(), vend.tolist()):
            b.add(*rec)
        return b.tobytes()
    bins = _reg2bin_vec(beg, end)
    # chunks: records of one bin in file order, merged where one ends at
    # the next one's start (TabixIndexBuilder.add)
    order = np.lexsort((np.arange(len(tid)), bins, tid))
    t_s, b_s, vb_s, ve_s = tid[order], bins[order], vbeg[order], vend[order]
    new = np.ones(len(order), bool)
    new[1:] = ((t_s[1:] != t_s[:-1]) | (b_s[1:] != b_s[:-1]) |
               (vb_s[1:] != ve_s[:-1]))
    starts = np.flatnonzero(new)
    stops = np.append(starts[1:], len(order)) - 1
    for t, bn, cb, ce in zip(t_s[starts].tolist(), b_s[starts].tolist(),
                             vb_s[starts].tolist(), ve_s[stops].tolist()):
        b._bins[t].setdefault(bn, []).append([cb, ce])
    # linear index: each 16 KiB window a record touches takes the first
    # nonzero start, in file order, of the records touching it
    w0 = beg >> _MIN_SHIFT
    w1 = np.maximum(beg, end - 1) >> _MIN_SHIFT
    span = w1 - w0 + 1
    rec = np.repeat(np.arange(len(tid)), span)
    win = w0[rec] + np.arange(len(rec)) - np.repeat(np.cumsum(span) - span,
                                                    span)
    keep = vbeg[rec] != 0
    rec, win = rec[keep], win[keep]
    order = np.lexsort((np.arange(len(rec)), win, tid[rec]))
    t_o, w_o, r_o = tid[rec][order], win[order], rec[order]
    first = np.ones(len(order), bool)
    first[1:] = (t_o[1:] != t_o[:-1]) | (w_o[1:] != w_o[:-1])
    t_f, w_f, v_f = t_o[first], w_o[first], vbeg[r_o[first]]
    n_win = np.zeros(len(names), np.int64)
    np.maximum.at(n_win, tid, w1 + 1)
    bounds = np.searchsorted(t_f, np.arange(len(names) + 1))
    for t in range(len(names)):
        lin = np.zeros(int(n_win[t]), np.int64)
        lin[w_f[bounds[t]:bounds[t + 1]]] = v_f[bounds[t]:bounds[t + 1]]
        b._linear[t] = lin.tolist()
    return b.tobytes()


def _vcf_records(text):
    """(tid, beg, end, ustart, uend, names) of the VCF text's records as
    build_text_index reads them (`vcf_tbx_scan`): line starts and one past
    their ends, contigs in order of first appearance."""
    import ctypes

    import numpy as np

    from . import native as native_mod
    text = np.asarray(text, np.uint8)
    cap = int(np.count_nonzero(text == 10)) + 1
    tid = np.empty(cap, np.int32)
    cols = [np.empty(cap, np.int64) for _ in range(6)]
    ptr = ctypes.c_void_p
    n = native_mod.get_lib().vcf_tbx_scan(
        text.ctypes.data_as(ptr), len(text), cap, tid.ctypes.data_as(ptr),
        *[c.ctypes.data_as(ptr) for c in cols])
    if n < 0:
        raise ValueError("a VCF record's POS is not a plain number")
    beg, end, ustart, uend, nstart, nlen = (c[:n] for c in cols)
    n_names = int(tid[:n].max()) + 1 if n else 0
    names = [text[a:a + k].tobytes().decode() for a, k in
             zip(nstart[:n_names].tolist(), nlen[:n_names].tolist())]
    return tid[:n].astype(np.int64), beg, end, ustart, uend, names


CSI_MAGIC = b"CSI\x01"


def _reg2bin_g(beg: int, end: int, min_shift: int, depth: int) -> int:
    """Generalized CSI binning."""
    end -= 1
    level_off = 0
    # cumulative offsets per level: ((1 << 3*l) - 1) / 7
    for lvl in range(depth, 0, -1):
        shift = min_shift + 3 * (depth - lvl)
        if beg >> shift == end >> shift:
            return ((1 << (3 * lvl)) - 1) // 7 + (beg >> shift)
    return 0


def _reg2bins_g(beg: int, end: int, min_shift: int, depth: int) -> List[int]:
    if beg >= end:
        return []
    end -= 1
    bins = [0]
    for lvl in range(1, depth + 1):
        shift = min_shift + 3 * (depth - lvl)
        off = ((1 << (3 * lvl)) - 1) // 7
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def build_csi_index(vcf_gz_path: str, csi_path: Optional[str] = None,
                    min_shift: int = 14, depth: int = 5) -> None:
    """CSI index for a bgzipped VCF (equivalent of `tabix --csi -p vcf`)."""
    import bisect

    raw = open(vcf_gz_path, "rb").read()
    offs: List[int] = []
    plens: List[int] = []
    payloads: List[bytes] = []
    off = 0
    while off < len(raw):
        payload, bsize = bgzf.decompress_block(raw, off)
        offs.append(off)
        plens.append(len(payload))
        payloads.append(payload)
        off += bsize
    data = b"".join(payloads)
    uends: List[int] = []
    acc = 0
    for n in plens:
        acc += n
        uends.append(acc)

    def uoff2voff(u: int) -> int:
        bi = bisect.bisect_right(uends, u)
        if bi >= len(offs):
            bi = len(offs) - 1
        return (offs[bi] << 16) | (u - (uends[bi] - plens[bi]))

    names: List[str] = []
    name_idx: Dict[str, int] = {}
    # per ref: bin -> [loffset, chunks]
    refs: List[Dict[int, list]] = []
    pos = 0
    n_total = len(data)
    while pos < n_total:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n_total
        line = data[pos:nl]
        if line and not line.startswith(b"#"):
            cols = line.split(b"\t", 4)
            chrom = cols[0].decode()
            p1 = int(cols[1])
            ref = cols[3] if len(cols) > 3 else b"N"
            beg0, end0 = p1 - 1, p1 - 1 + len(ref)
            if chrom not in name_idx:
                name_idx[chrom] = len(names)
                names.append(chrom)
                refs.append({})
            b = _reg2bin_g(beg0, end0, min_shift, depth)
            vbeg, vend = uoff2voff(pos), uoff2voff(nl + 1)
            bins = refs[name_idx[chrom]]
            if b not in bins:
                bins[b] = [vbeg, []]  # loffset = first voff in bin
            entry = bins[b]
            if entry[1] and entry[1][-1][1] == vbeg:
                entry[1][-1][1] = vend
            else:
                entry[1].append([vbeg, vend])
        pos = nl + 1

    out = [CSI_MAGIC, struct.pack("<ii", min_shift, depth)]
    # aux: tabix conf (6 ints) + names, as htslib writes for tabix-over-csi
    nm = b"".join(n.encode() + b"\x00" for n in names)
    aux = struct.pack("<4i", FMT_VCF, 1, 2, 0) + struct.pack("<2i", ord("#"), 0) \
        + struct.pack("<i", len(nm)) + nm
    out.append(struct.pack("<i", len(aux)))
    out.append(aux)
    out.append(struct.pack("<i", len(refs)))
    for bins in refs:
        out.append(struct.pack("<i", len(bins)))
        for b in sorted(bins):
            loffset, chunks = bins[b]
            out.append(struct.pack("<IQi", b, loffset, len(chunks)))
            for cb, ce in chunks:
                out.append(struct.pack("<QQ", cb, ce))
    out.append(struct.pack("<Q", 0))  # n_no_coor
    bgzf.compress_to_path(b"".join(out), csi_path or vcf_gz_path + ".csi")


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-then-rename so concurrent readers never observe a partial
    index: N sharded engine processes may race to build the same .bai
    (round-4 advisor finding — a peer that saw the file mid-write parsed a
    truncated BAI and crashed its shard plan)."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def build_bai_index(bam_path: str, bai_path: Optional[str] = None) -> None:
    """BAI index for a BAM file (equivalent of `samtools index`).

    Fast path: native single-pass record scan (C++) + vectorized numpy
    binning/linear-index construction — indexing runs at decode speed
    instead of a per-record Python loop (the reference relies on samtools
    for this; phaser_tpu carries its own indexer for the mapper fixtures,
    shard planning, and decode skipping). Output bytes identical to the
    pure-Python fallback."""
    if _build_bai_index_native(bam_path, bai_path):
        return
    _build_bai_index_python(bam_path, bai_path)


def _reg2bin_vec(beg, end):
    import numpy as np
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for lvl in range(_N_LVLS, 0, -1):
        shift = _MIN_SHIFT + 3 * (_N_LVLS - lvl)
        m = ~done & ((beg >> shift) == (e >> shift))
        out[m] = _BIN_OFFSETS[lvl] + (beg[m] >> shift)
        done |= m
    return out


def _native_bam_scan(bam_path: str):
    """Native record scan for index building: returns
    (n_ref, ridm, begm, endm, vb, ve) arrays over MAPPED records in file
    order (positions int64, voffsets int64), or None without the native
    library / on a malformed BAM."""
    import ctypes

    import numpy as np

    from . import native as native_mod
    lib = native_mod.get_lib()
    if lib is None or not hasattr(lib, "bam_index_scan"):
        return None
    raw = open(bam_path, "rb").read()
    ptr = ctypes.c_void_p
    total = lib.bgzf_total_size(raw, len(raw))
    if total < 0:
        return None
    ubuf = np.empty(max(total, 1), np.uint8)
    import os as _os
    nthr = min(_os.cpu_count() or 1, 8)
    if lib.bgzf_decompress(raw, len(raw),
                           ubuf.ctypes.data_as(ptr), nthr) != total:
        return None
    consumed = ctypes.c_int64(0)
    h = lib.bam_header_only(ubuf.ctypes.data_as(ptr), total,
                            ctypes.byref(consumed))
    if not h:
        return None
    n_ref = lib.bam_n_refs(h)
    lib.bam_free(h)
    body = ubuf[consumed.value:]
    cap = len(body) // 36 + 1
    rid = np.empty(cap, np.int32)
    pos0 = np.empty(cap, np.int32)
    end0 = np.empty(cap, np.int32)
    ubeg = np.empty(cap, np.int64)
    uend = np.empty(cap, np.int64)
    n = lib.bam_index_scan(
        np.ascontiguousarray(body).ctypes.data_as(ptr), len(body), cap,
        rid.ctypes.data_as(ptr), pos0.ctypes.data_as(ptr),
        end0.ctypes.data_as(ptr), ubeg.ctypes.data_as(ptr),
        uend.ctypes.data_as(ptr))
    if n < 0:
        return None
    rid, pos0, end0 = rid[:n], pos0[:n].astype(np.int64), \
        end0[:n].astype(np.int64)
    ubeg = ubeg[:n] + consumed.value
    uend = uend[:n] + consumed.value

    # block tables for uoff -> voff translation (python header walk is
    # O(blocks), trivial next to the scan)
    offs = np.array(bgzf.block_offsets(raw), np.int64)
    nxt = np.concatenate([offs[1:], [len(raw)]])
    isz_bytes = np.frombuffer(raw, np.uint8)[
        (nxt[:, None] - 4 + np.arange(4)[None, :]).reshape(-1)]
    isize = isz_bytes.reshape(-1, 4).copy().view("<u4").reshape(-1)\
        .astype(np.int64)
    uends = np.cumsum(isize)

    def uoff2voff(u):
        bi = np.minimum(np.searchsorted(uends, u, side="right"),
                        len(offs) - 1)
        ustart = uends[bi] - isize[bi]
        return (offs[bi] << 16) | (u - ustart)

    vbeg = uoff2voff(ubeg)
    vend = uoff2voff(uend)

    mapped = rid >= 0
    return (n_ref, rid[mapped].astype(np.int64), pos0[mapped],
            end0[mapped], vbeg[mapped], vend[mapped])


def _build_bai_index_native(bam_path: str,
                            bai_path: Optional[str]) -> bool:
    import struct as _s

    import numpy as np

    scan = _native_bam_scan(bam_path)
    if scan is None:
        return False
    n_ref, ridm, begm, endm, vb, ve = scan
    bins = _reg2bin_vec(begm, endm)

    # group by (rid, bin) keeping file order; merge chunks contiguous in
    # the file (prev chunk end == next record begin), matching the
    # python indexer exactly
    order = np.lexsort((np.arange(len(ridm)), bins, ridm))
    r_s, b_s, vb_s, ve_s = ridm[order], bins[order], vb[order], ve[order]
    new_group = np.ones(len(r_s), bool)
    if len(r_s) > 1:
        new_group[1:] = ((r_s[1:] != r_s[:-1]) | (b_s[1:] != b_s[:-1]) |
                         (vb_s[1:] != ve_s[:-1]))
    starts = np.flatnonzero(new_group)
    ends = np.concatenate([starts[1:], [len(r_s)]])
    c_rid = r_s[starts]
    c_bin = b_s[starts]
    c_vb = vb_s[starts]
    c_ve = ve_s[ends - 1]

    # linear index per rid: first-touch voffset per 16 KiB window (file
    # order => nondecreasing voffs => first touch == min), zeros
    # forward-filled with the previous nonzero
    out = [b"BAI\x01", _s.pack("<i", n_ref)]
    for r in range(n_ref):
        sel = np.flatnonzero(c_rid == r)
        bb = c_bin[sel]
        bstarts = np.flatnonzero(np.concatenate([[True],
                                                 bb[1:] != bb[:-1]])) \
            if len(bb) else np.zeros(0, np.int64)
        bends = np.concatenate([bstarts[1:], [len(bb)]]) if len(bb) \
            else bstarts
        out.append(_s.pack("<i", len(bstarts)))
        for s0, e0 in zip(bstarts, bends):
            out.append(_s.pack("<Ii", int(bb[s0]), int(e0 - s0)))
            for i in sel[s0:e0]:
                out.append(_s.pack("<QQ", int(c_vb[i]), int(c_ve[i])))
        rm = ridm == r
        if rm.any():
            wb = begm[rm] >> _MIN_SHIFT
            we = (endm[rm] - 1) >> _MIN_SHIFT
            vbr = vb[rm]
            n_win = int(we.max()) + 1
            lin = np.full(n_win, np.iinfo(np.int64).max, np.int64)
            counts = (we - wb + 1)
            widx = np.repeat(wb, counts) + (
                np.arange(int(counts.sum())) -
                np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                          counts))
            np.minimum.at(lin, widx, np.repeat(vbr, counts))
            lin[lin == np.iinfo(np.int64).max] = 0
            # forward-fill zeros with the previous nonzero value
            nz = lin > 0
            idx = np.where(nz, np.arange(n_win), -1)
            np.maximum.accumulate(idx, out=idx)
            lin = np.where(idx >= 0, lin[np.maximum(idx, 0)], 0)
        else:
            lin = np.zeros(0, np.int64)
        out.append(_s.pack("<i", len(lin)))
        if len(lin):
            out.append(lin.astype("<u8").tobytes())
    _atomic_write_bytes(bai_path or bam_path + ".bai", b"".join(out))
    return True


def _reg2bin_vec_g(beg, end, min_shift: int, depth: int):
    """Vectorized generalized (CSI) binning."""
    import numpy as np
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for lvl in range(depth, 0, -1):
        shift = min_shift + 3 * (depth - lvl)
        m = ~done & ((beg >> shift) == (e >> shift))
        out[m] = ((1 << (3 * lvl)) - 1) // 7 + (beg[m] >> shift)
        done |= m
    return out


def build_csi_bam_index(bam_path: str, csi_path: Optional[str] = None,
                        min_shift: int = 14,
                        depth: Optional[int] = None) -> None:
    """CSI index for a BAM (`samtools index -c` equivalent): the
    generalized R-tree removes BAI's 512 Mbp contig limit.  depth defaults
    to the smallest level count covering the highest mapped coordinate
    (>= the samtools default of 5).  Requires the native record scan.

    Layout (htslib CSI spec): bgzf("CSI\1", min_shift, depth, l_aux=0,
    n_ref, {n_bin, {bin u32, loffset u64, n_chunk, {beg u64, end u64}}}),
    n_no_coor u64).  loffset(bin) is the record-level linear-index value
    at the bin's first leaf window — the reader rebuilds a BAI-style
    2^min_shift linear index from leaf loffsets plus parent smears."""
    import struct as _s

    import numpy as np

    scan = _native_bam_scan(bam_path)
    if scan is None:
        raise RuntimeError("CSI building requires the native library")
    n_ref, ridm, begm, endm, vb, ve = scan
    if depth is None:
        depth = 5
        max_end = int(endm.max()) if len(endm) else 0
        while (1 << (min_shift + 3 * depth)) < max_end:
            depth += 1
    bins = _reg2bin_vec_g(begm, endm, min_shift, depth)
    leaf_off = ((1 << (3 * depth)) - 1) // 7

    # chunk merge per (rid, bin), preserving file order — identical
    # grouping to the BAI indexer
    order = np.lexsort((np.arange(len(ridm)), bins, ridm))
    r_s, b_s, vb_s, ve_s = ridm[order], bins[order], vb[order], ve[order]
    new_group = np.ones(len(r_s), bool)
    if len(r_s) > 1:
        new_group[1:] = ((r_s[1:] != r_s[:-1]) | (b_s[1:] != b_s[:-1]) |
                         (vb_s[1:] != ve_s[:-1]))
    starts = np.flatnonzero(new_group)
    ends = np.concatenate([starts[1:], [len(r_s)]]) if len(starts) \
        else starts
    c_rid = r_s[starts]
    c_bin = b_s[starts]
    c_vb = vb_s[starts]
    c_ve = ve_s[ends - 1] if len(starts) else c_bin

    out = [CSI_MAGIC, _s.pack("<iii", min_shift, depth, 0),
           _s.pack("<i", n_ref)]
    for r in range(n_ref):
        rm = ridm == r
        # record-level linear index at 2^min_shift granularity (same
        # construction as the BAI indexer), used for per-bin loffsets
        if rm.any():
            wb = begm[rm] >> min_shift
            we = (endm[rm] - 1) >> min_shift
            vbr = vb[rm]
            n_win = int(we.max()) + 1
            lin = np.full(n_win, np.iinfo(np.int64).max, np.int64)
            counts = (we - wb + 1)
            widx = np.repeat(wb, counts) + (
                np.arange(int(counts.sum())) -
                np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                          counts))
            np.minimum.at(lin, widx, np.repeat(vbr, counts))
            lin[lin == np.iinfo(np.int64).max] = 0
            nz = lin > 0
            idx = np.where(nz, np.arange(n_win), -1)
            np.maximum.accumulate(idx, out=idx)
            lin = np.where(idx >= 0, lin[np.maximum(idx, 0)], 0)
        else:
            lin = np.zeros(0, np.int64)

        sel = np.flatnonzero(c_rid == r)
        bb = c_bin[sel]
        bstarts = np.flatnonzero(np.concatenate([[True],
                                                 bb[1:] != bb[:-1]])) \
            if len(bb) else np.zeros(0, np.int64)
        bends = np.concatenate([bstarts[1:], [len(bb)]]) if len(bb) \
            else bstarts
        out.append(_s.pack("<i", len(bstarts)))
        for s0, e0 in zip(bstarts, bends):
            b = int(bb[s0])
            # first leaf window of this bin's interval
            if b >= leaf_off:
                lvl = depth
                w0 = b - leaf_off
            else:
                lvl = 0
                acc = 0
                for lv in range(depth + 1):
                    off_l = ((1 << (3 * lv)) - 1) // 7
                    nxt = ((1 << (3 * (lv + 1))) - 1) // 7
                    if off_l <= b < nxt:
                        lvl = lv
                        break
                w0 = (b - ((1 << (3 * lvl)) - 1) // 7) * \
                    (1 << (3 * (depth - lvl)))
            loffset = int(lin[w0]) if w0 < len(lin) else \
                (int(lin[-1]) if len(lin) else 0)
            out.append(_s.pack("<IQi", b, loffset, int(e0 - s0)))
            for i in sel[s0:e0]:
                out.append(_s.pack("<QQ", int(c_vb[i]), int(c_ve[i])))
    out.append(_s.pack("<Q", 0))  # n_no_coor
    dest = csi_path or bam_path + ".csi"
    tmp = "%s.tmp.%d" % (dest, os.getpid())
    bgzf.compress_to_path(b"".join(out), tmp)
    os.replace(tmp, dest)


def _build_bai_index_python(bam_path: str,
                            bai_path: Optional[str] = None) -> None:
    """Pure-Python BAI indexer (fallback; byte-identical output)."""
    import bisect
    import struct as _s

    raw = open(bam_path, "rb").read()
    offs: List[int] = []
    plens: List[int] = []
    payloads: List[bytes] = []
    off = 0
    while off < len(raw):
        payload, bsize = bgzf.decompress_block(raw, off)
        offs.append(off)
        plens.append(len(payload))
        payloads.append(payload)
        off += bsize
    data = b"".join(payloads)
    uends: List[int] = []
    acc = 0
    for n in plens:
        acc += n
        uends.append(acc)

    def uoff2voff(u: int) -> int:
        bi = bisect.bisect_right(uends, u)
        if bi >= len(offs):
            bi = len(offs) - 1
        return (offs[bi] << 16) | (u - (uends[bi] - plens[bi]))

    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = _s.unpack_from("<i", data, 4)
    p = 8 + l_text
    (n_ref,) = _s.unpack_from("<i", data, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = _s.unpack_from("<i", data, p)
        p += 4 + l_name + 4
    refs: List[Dict[int, list]] = [dict() for _ in range(n_ref)]
    linear: List[List[int]] = [[] for _ in range(n_ref)]
    while p + 4 <= len(data):
        (block_size,) = _s.unpack_from("<i", data, p)
        rec_vbeg = uoff2voff(p)
        rec_vend = uoff2voff(p + 4 + block_size)
        rid, pos0 = _s.unpack_from("<ii", data, p + 4)
        n_cigar, = _s.unpack_from("<H", data, p + 4 + 12)
        # reference span from cigar
        span = 0
        coff = p + 4 + 32 + data[p + 4 + 8]  # + l_read_name
        for ci in range(n_cigar):
            (op,) = _s.unpack_from("<I", data, coff + 4 * ci)
            if (op & 0xF) in (0, 2, 3, 7, 8):
                span += op >> 4
        end0 = pos0 + max(span, 1)
        p += 4 + block_size
        if rid < 0:
            continue
        b = reg2bin(pos0, end0)
        chunks = refs[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == rec_vbeg:
            chunks[-1][1] = rec_vend
        else:
            chunks.append([rec_vbeg, rec_vend])
        lin = linear[rid]
        w_beg, w_end = pos0 >> _MIN_SHIFT, (end0 - 1) >> _MIN_SHIFT
        if len(lin) <= w_end:
            lin.extend([0] * (w_end + 1 - len(lin)))
        for w in range(w_beg, w_end + 1):
            if lin[w] == 0:
                lin[w] = rec_vbeg

    out = [b"BAI\x01", _s.pack("<i", n_ref)]
    for rid in range(n_ref):
        bins = refs[rid]
        out.append(_s.pack("<i", len(bins)))
        for b in sorted(bins):
            chunks = bins[b]
            out.append(_s.pack("<Ii", b, len(chunks)))
            for cb, ce in chunks:
                out.append(_s.pack("<QQ", cb, ce))
        lin = linear[rid]
        prev = 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = prev
            else:
                prev = v
        out.append(_s.pack("<i", len(lin)))
        if lin:
            out.append(_s.pack("<%dQ" % len(lin), *lin))
    _atomic_write_bytes(bai_path or bam_path + ".bai", b"".join(out))


class TabixFile:
    """Region fetch over a bgzipped + (tabix or CSI) indexed text file."""

    def __init__(self, path: str, index_path: Optional[str] = None):
        self.path = path
        self._reader = bgzf.BgzfReader(path)
        if index_path is None:
            import os
            index_path = path + ".tbi"
            if not os.path.isfile(index_path) and os.path.isfile(path + ".csi"):
                index_path = path + ".csi"
        idx = bgzf.decompress_all(open(index_path, "rb").read())
        if idx[:4] == CSI_MAGIC:
            self._parse_csi(idx)
        else:
            self._parse_index(idx)

    def _parse_csi(self, buf: bytes) -> None:
        off = 4
        self._min_shift, self._depth = struct.unpack_from("<ii", buf, off)
        off += 8
        (l_aux,) = struct.unpack_from("<i", buf, off); off += 4
        aux = buf[off:off + l_aux]; off += l_aux
        self.conf = struct.unpack_from("<6i", aux, 0)
        (l_nm,) = struct.unpack_from("<i", aux, 24)
        self.names = [n.decode() for n in aux[28:28 + l_nm].split(b"\x00")[:-1]]
        self.name_idx = {n: i for i, n in enumerate(self.names)}
        (n_ref,) = struct.unpack_from("<i", buf, off); off += 4
        self._bins = []
        self._loffsets = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", buf, off); off += 4
            bins = {}
            loffs = {}
            for _ in range(n_bin):
                b, loffset, n_chunk = struct.unpack_from("<IQi", buf, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off); off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
                loffs[b] = loffset
            self._bins.append(bins)
            self._loffsets.append(loffs)
        self._linear = None  # CSI has loffsets per bin instead
        self._is_csi = True

    def _parse_index(self, buf: bytes) -> None:
        self._is_csi = False
        if buf[:4] != TBI_MAGIC:
            raise ValueError("bad TBI magic")
        off = 4
        (n_ref,) = struct.unpack_from("<i", buf, off); off += 4
        self.conf = struct.unpack_from("<6i", buf, off); off += 24
        (l_nm,) = struct.unpack_from("<i", buf, off); off += 4
        self.names = buf[off:off + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in self.names]
        off += l_nm
        self.name_idx = {n: i for i, n in enumerate(self.names)}
        self._bins = []
        self._linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", buf, off); off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", buf, off); off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off); off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", buf, off); off += 4
            lin = struct.unpack_from("<%dQ" % n_intv, buf, off); off += 8 * n_intv
            self._bins.append(bins)
            self._linear.append(lin)

    def fetch(self, chrom: str, beg0: int, end0: int):
        """Yield text lines overlapping [beg0, end0) (0-based half-open)."""
        if chrom not in self.name_idx:
            return
        tid = self.name_idx[chrom]
        bins = self._bins[tid]
        if getattr(self, "_is_csi", False):
            cand_bins = _reg2bins_g(beg0, end0, self._min_shift, self._depth)
            min_voff = 0
        else:
            cand_bins = reg2bins(beg0, end0)
            lin = self._linear[tid]
            w = beg0 >> _MIN_SHIFT
            min_voff = lin[w] if w < len(lin) else (lin[-1] if lin else 0)
        chunks = []
        for b in cand_bins:
            for cb, ce in bins.get(b, ()):
                if ce > min_voff:
                    chunks.append((max(cb, min_voff), ce))
        if not chunks:
            return
        chunks.sort()
        # coalesce overlapping/adjacent chunk ranges (chunk voffs always fall
        # on record boundaries)
        merged = [list(chunks[0])]
        for cb, ce in chunks[1:]:
            if cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        fmt, col_seq, col_beg, col_end, meta, skip = self.conf
        zero_based = bool(fmt & FLAG_UCSC)
        fmt &= 0xFFFF
        for cb, ce in merged:
            data = self._reader.read_range(cb, ce)
            limit = None
            for line in data.split(b"\n"):
                if not line or line[0:1] == bytes([meta & 0xFF]):
                    continue
                cols = line.split(b"\t")
                if cols[0].decode() != chrom:
                    continue
                try:
                    if fmt == FMT_VCF:
                        rb = int(cols[1]) - 1
                        re_ = rb + len(cols[3]) if len(cols) > 3 else rb + 1
                    else:
                        rb = int(cols[col_beg - 1]) - (0 if zero_based else 1)
                        re_ = int(cols[col_end - 1]) if col_end != col_beg else rb + 1
                        if zero_based and col_end == col_beg:
                            re_ = rb + 1
                except (ValueError, IndexError):
                    continue
                if rb >= end0:
                    limit = True
                    break
                if re_ > beg0:
                    yield line.decode()
            if limit:
                break
