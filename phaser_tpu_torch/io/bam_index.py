"""BAI index reading + index-driven region/range BAM decode.

The reference reaches indexed access by shelling out to samtools
(`samtools view -h BAM 'chrom':` region pipes plus `-L sites.bed`,
reference phaser/phaser.py:1346) — which still INFLATES every BGZF
block of the region stream.  phaser_tpu reads the BAI itself and
decompresses only the blocks that can contain wanted records:

  * BaiIndex            — parsed .bai (bins + 16 KiB linear index)
  * read_bam_voffset_ranges — decode an explicit merged voffset-range list
    (the samtools region algorithm's chunk union; used for het-site
    decode skipping, where sites cover a small genome fraction)
  * read_bam_starts     — all reads of one contig with START in [lo, hi)
    (the position-range engine shard unit: reads are coordinate-sorted,
    so the scan starts at the linear-index voffset and stops at the first
    read past hi)
  * concat_bam          — stitch BamData chunks (file order preserved)

Decode uses the native multithreaded BGZF inflater when available, with a
pure-Python fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import bgzf
from .bam import BamData, NameView, _parse_records_v2, read_bam
from .tabix import CSI_MAGIC, _reg2bins_g, reg2bins

_MIN_SHIFT = 14  # 16 KiB linear-index windows (BAI fixed)


class BaiIndex:
    """Parsed BAM index — BAI or CSI behind one query interface.

    BAI: classic (min_shift=14, depth=5) bins + the 16 KiB linear index.
    CSI (`samtools index -c`; removes the 512 Mbp contig limit): the
    generalized R-tree; a BAI-style 2^min_shift linear index is
    SYNTHESIZED from per-bin loffsets — leaf-bin loffsets give window
    granularity, parent-bin smears keep the lower-bound contract for
    reads resident in non-leaf bins (a window's value is always <= the
    voffset of every read overlapping it, so start_voff/chunk queries
    stay conservative-correct)."""

    def __init__(self, bins: List[Dict[int, List[Tuple[int, int]]]],
                 linear: List[np.ndarray], min_shift: int = 14,
                 depth: int = 5):
        self.bins = bins
        self.linear = linear
        self.min_shift = min_shift
        self.depth = depth

    @classmethod
    def from_path(cls, path: str) -> "BaiIndex":
        buf = open(path, "rb").read()
        if buf[:2] == b"\x1f\x8b":
            data = bgzf.decompress_all(buf)
            if data[:4] != CSI_MAGIC:
                raise ValueError("gzipped index is not CSI: %s" % path)
            return cls._parse_csi(data)
        if buf[:4] != b"BAI\x01":
            raise ValueError("bad BAI magic in %s" % path)
        off = 4
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        bins: List[Dict[int, List[Tuple[int, int]]]] = []
        linear: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", buf, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", buf, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off)
                    off += 16
                    chunks.append((cb, ce))
                bd[b] = chunks
            (n_intv,) = struct.unpack_from("<i", buf, off)
            off += 4
            lin = np.frombuffer(buf, "<u8", n_intv, off).copy()
            off += 8 * n_intv
            bins.append(bd)
            linear.append(lin)
        return cls(bins, linear)

    @classmethod
    def _parse_csi(cls, buf: bytes) -> "BaiIndex":
        min_shift, depth, l_aux = struct.unpack_from("<iii", buf, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        leaf_off = ((1 << (3 * depth)) - 1) // 7
        bins: List[Dict[int, List[Tuple[int, int]]]] = []
        linear: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", buf, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            loffs: List[Tuple[int, int]] = []   # (bin, loffset)
            for _ in range(n_bin):
                b, loffset, n_chunk = struct.unpack_from("<IQi", buf, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off)
                    off += 16
                    chunks.append((cb, ce))
                bd[b] = chunks
                loffs.append((int(b), int(loffset)))
            # synthesize the linear index: leaf loffsets at window
            # granularity + parent smears over their full leaf span (the
            # lower-bound that keeps reads in non-leaf bins reachable and
            # makes "no nonzero window >= w" mean "no read at/after w",
            # exactly like the BAI linear)
            spans = []
            for b, lo in loffs:
                if b >= leaf_off:
                    ilo, ihi = b - leaf_off, b - leaf_off + 1
                else:
                    lvl = 0
                    for lv in range(depth + 1):
                        if ((1 << (3 * lv)) - 1) // 7 <= b < \
                                ((1 << (3 * (lv + 1))) - 1) // 7:
                            lvl = lv
                            break
                    span = 1 << (3 * (depth - lvl))
                    ilo = (b - ((1 << (3 * lvl)) - 1) // 7) * span
                    ihi = ilo + span
                val = lo if lo > 0 else (min(c[0] for c in bd[b])
                                         if bd[b] else 0)
                spans.append((ilo, ihi, val))
            n_win = max((ihi for ilo, ihi, v in spans), default=0)
            big = np.iinfo(np.int64).max
            lin = np.full(n_win, big, np.int64)
            for ilo, ihi, val in spans:
                if val <= 0:
                    continue
                np.minimum.at(lin, np.s_[ilo:ihi], val)
            lin[lin == big] = 0
            bins.append(bd)
            linear.append(lin)
        return cls(bins, linear, min_shift=min_shift, depth=depth)

    def n_ref(self) -> int:
        return len(self.bins)

    def start_voff(self, tid: int, pos0: int) -> Optional[int]:
        """Virtual offset at which a scan for reads with start >= pos0 can
        begin (every read with start >= pos0 lies at or after it), or None
        when the index proves no such read exists."""
        lin = self.linear[tid]
        w = pos0 >> self.min_shift
        if w >= len(lin):
            return None
        nz = np.flatnonzero(lin[w:])
        if nz.size == 0:
            return None
        return int(lin[w + nz[0]])

    def chunks_for_region(self, tid: int, beg0: int,
                          end0: int) -> List[Tuple[int, int]]:
        """Merged voffset chunk list containing EVERY read overlapping
        [beg0, end0) — the samtools query algorithm (reg2bins union,
        lower-bounded by the linear index)."""
        bd = self.bins[tid]
        lin = self.linear[tid]
        w = beg0 >> self.min_shift
        min_voff = int(lin[w]) if w < len(lin) else \
            (int(lin[-1]) if len(lin) else 0)
        chunks = []
        if self.min_shift == 14 and self.depth == 5:
            query_bins = reg2bins(beg0, end0)
        else:
            query_bins = _reg2bins_g(beg0, end0, self.min_shift,
                                     self.depth)
        for b in query_bins:
            for cb, ce in bd.get(b, ()):
                if ce > min_voff:
                    chunks.append((max(cb, min_voff), ce))
        return merge_voffset_ranges(chunks)

    def contig_coffset_span(self, tid: int) -> Tuple[int, int]:
        """(first, last) compressed-file offsets the linear index records
        for this reference — the byte weight of its reads (0, 0) if none."""
        lin = self.linear[tid]
        nz = lin[lin > 0]
        if nz.size == 0:
            return (0, 0)
        return (int(nz.min() >> 16), int(nz.max() >> 16))


def merge_voffset_ranges(chunks: Sequence[Tuple[int, int]]
                         ) -> List[Tuple[int, int]]:
    if not chunks:
        return []
    out = [list(c) for c in sorted(chunks)][:1]
    for cb, ce in sorted(chunks)[1:]:
        if cb <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ce)
        else:
            out.append([cb, ce])
    return [(int(a), int(b)) for a, b in out]


def plan_site_ranges(bai: BaiIndex, tid: int, beg0: np.ndarray,
                     end0: np.ndarray,
                     merge_gap: int = 16384) -> List[Tuple[int, int]]:
    """Merged voffset chunks guaranteed to contain EVERY read overlapping
    any [beg0[i], end0[i]) site interval — the in-process equivalent of
    the reference's `samtools view -L sites.bed` region filter
    (reference phaser/phaser.py:1346,1405), except blocks outside
    the chunks are never inflated at all (samtools still decodes the whole
    stream). Nearby sites merge so the bin-query count stays small."""
    if len(beg0) == 0:
        return []
    order = np.argsort(beg0, kind="stable")
    iv: List[List[int]] = []
    for i in order:
        b, e = int(beg0[i]), int(end0[i])
        if iv and b - iv[-1][1] <= merge_gap:
            iv[-1][1] = max(iv[-1][1], e)
        else:
            iv.append([b, e])
    chunks: List[Tuple[int, int]] = []
    for b, e in iv:
        chunks.extend(bai.chunks_for_region(tid, b, e))
    return chunks


def ranges_compressed_bytes(vranges: Sequence[Tuple[int, int]],
                            path: Optional[str] = None) -> int:
    """Compressed bytes covered by merged voffset ranges. With `path`,
    EXACT — index coffsets are block starts, so each range's true end is
    found with a two-read probe of its final block; without, a
    64 KiB-per-range upper bound."""
    if path is not None:
        total = 0
        with open(path, "rb") as fh:
            for vb, ve in vranges:
                cb = vb >> 16
                ce, ue = ve >> 16, ve & 0xFFFF
                end = ce
                if ue > 0:
                    bsize, _ = _block_meta_at(fh, ce)
                    end = ce + bsize
                total += max(end - cb, 0)
        return total
    total = 0
    for vb, ve in vranges:
        total += (ve >> 16) - (vb >> 16) + (1 << 16)
    return total


def find_bam_index(bam_path: str) -> Optional[str]:
    """Existing index path (.bai preferred, then .csi), or None."""
    import os
    for ext in (".bai", ".csi"):
        if os.path.isfile(bam_path + ext):
            return bam_path + ext
    return None


def ensure_bam_index(bam_path: str) -> Optional[str]:
    """Path of an index for the BAM, building one if absent: BAI for
    classic genomes, CSI when any contig exceeds the 512 Mbp BAI limit
    (the reference reaches CSI transparently through samtools,
    reference phaser/phaser.py:1346). None if none can be
    produced."""
    import os
    p = find_bam_index(bam_path)
    if p is not None:
        return p
    try:
        _, ref_lengths, _ = read_bam_header_meta(bam_path)
        if ref_lengths and max(ref_lengths) >= (1 << 29):
            from .tabix import build_csi_bam_index
            build_csi_bam_index(bam_path)
            p = bam_path + ".csi"
        else:
            from .tabix import build_bai_index
            build_bai_index(bam_path)
            p = bam_path + ".bai"
    except Exception:
        return None
    return p if os.path.isfile(p) else None


# historical name: callers predate CSI support
ensure_bai = ensure_bam_index


# ---------------------------------------------------------------------------
# decode helpers

def concat_bam(chunks: Sequence[BamData]) -> BamData:
    chunks = [c for c in chunks if c is not None]
    if not chunks:
        raise ValueError("concat_bam needs at least one chunk")
    if len(chunks) == 1:
        return chunks[0]
    first = chunks[0]

    def cat(attr):
        return np.concatenate([getattr(c, attr) for c in chunks])

    def cat_ragged(flat_attr, off_attr):
        flats = [getattr(c, flat_attr) for c in chunks]
        offs = [getattr(c, off_attr) for c in chunks]
        total = np.concatenate([flats[0]] + flats[1:]) if flats else None
        n = sum(len(c) for c in chunks)
        out_off = np.zeros(n + 1, np.int64)
        i = 0
        base = 0
        for c, off in zip(chunks, offs):
            k = len(c)
            out_off[i + 1:i + 1 + k] = base + off[1:]
            base += off[-1]
            i += k
        return total, out_off

    cigar_flat, cigar_off = cat_ragged("cigar_flat", "cigar_off")
    seq_flat, seq_off = cat_ragged("seq_flat", "seq_off")
    qual_flat, _ = cat_ragged("qual_flat", "seq_off")
    blobs = []
    name_off = np.zeros(sum(len(c) for c in chunks) + 1, np.int64)
    i = 0
    base = 0
    for c in chunks:
        nm = c.names
        if isinstance(nm, NameView):
            blob, off = nm.blob, nm.off
        else:
            blob = b"".join(nm)
            off = np.zeros(len(nm) + 1, np.int64)
            np.cumsum([len(x) for x in nm], out=off[1:])
        blobs.append(blob)
        k = len(c)
        name_off[i + 1:i + 1 + k] = base + off[1:1 + k]
        base += off[k]
        i += k
    names = NameView(b"".join(blobs), name_off)
    return BamData(
        ref_names=first.ref_names, ref_lengths=first.ref_lengths,
        header_text=first.header_text,
        refid=cat("refid"), pos=cat("pos"), mapq=cat("mapq"),
        flag=cat("flag"), tlen=cat("tlen"), as_score=cat("as_score"),
        has_as=cat("has_as"), names=names,
        cigar_flat=cigar_flat, cigar_off=cigar_off,
        seq_flat=seq_flat, qual_flat=qual_flat, seq_off=seq_off)


def _empty_like_header(ref_names, ref_lengths, header_text) -> BamData:
    z64 = np.zeros(1, np.int64)
    return BamData(
        ref_names=ref_names, ref_lengths=ref_lengths, header_text=header_text,
        refid=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
        mapq=np.zeros(0, np.uint8), flag=np.zeros(0, np.uint16),
        tlen=np.zeros(0, np.int32), as_score=np.zeros(0, np.int32),
        has_as=np.zeros(0, bool), names=NameView(b"", z64),
        cigar_flat=np.zeros(0, np.uint32), cigar_off=z64.copy(),
        seq_flat=np.zeros(0, np.uint8), qual_flat=np.zeros(0, np.uint8),
        seq_off=z64.copy())


def read_bam_header_meta(path: str):
    """(ref_names, ref_lengths, header_text) decoding only leading blocks."""
    from . import native as native_mod
    lib = native_mod.get_lib()
    raw = open(path, "rb").read(1 << 22)   # headers are small
    data = b""
    off = 0
    while off < len(raw):
        try:
            payload, bsize = bgzf.decompress_block(raw, off)
        except Exception:
            break
        data += payload
        off += bsize
        try:
            return _parse_header_text(data)
        except _NeedMore:
            continue
    # very large header: fall back to whole-file
    bd = read_bam(path)
    return bd.ref_names, bd.ref_lengths, bd.header_text


class _NeedMore(Exception):
    pass


def _parse_header_text(data: bytes):
    if len(data) < 8:
        raise _NeedMore
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8
    if len(data) < off + l_text + 4:
        raise _NeedMore
    header_text = data[off:off + l_text].split(b"\x00")[0].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        if len(data) < off + 4:
            raise _NeedMore
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        if len(data) < off + l_name + 4:
            raise _NeedMore
        ref_names.append(data[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        ref_lengths.append(l_ref)
        off += 4
    return ref_names, ref_lengths, header_text


def _block_meta_at(fh, coff: int) -> Tuple[int, int]:
    """(bsize, isize) of the BGZF block starting at file offset coff,
    probed with two tiny reads (header + trailer)."""
    fh.seek(coff)
    head = fh.read(64)
    bsize, _ = bgzf._parse_block_header(head, 0)
    fh.seek(coff + bsize - 4)
    (isize,) = struct.unpack("<I", fh.read(4))
    return bsize, isize


def _inflate_bytes(raw: np.ndarray, n_threads: int) -> np.ndarray:
    """Inflate a block-aligned compressed byte span."""
    import ctypes
    from . import native as native_mod
    lib = native_mod.get_lib()
    if lib is not None:
        total = lib.bgzf_total_size(raw.ctypes.data_as(ctypes.c_void_p),
                                    len(raw))
        if total >= 0:
            ubuf = np.empty(max(total, 1), np.uint8)
            got = lib.bgzf_decompress(
                raw.ctypes.data_as(ctypes.c_void_p), len(raw),
                ubuf.ctypes.data_as(ctypes.c_void_p), n_threads)
            if got == total:
                return ubuf[:total]
    return np.frombuffer(bgzf.decompress_all(raw.tobytes()), np.uint8)


def read_bam_voffset_ranges(path: str, vranges: Sequence[Tuple[int, int]],
                            n_threads: int = 0,
                            header_meta=None) -> BamData:
    """Decode ONLY the blocks covered by the given merged voffset ranges
    (record-aligned, e.g. from BaiIndex.chunks_for_region) and parse their
    records.  SEEK-based: index voffset coffsets are always block starts,
    so each range is read straight from disk — bytes outside every range
    are neither read nor inflated, and memory is bounded by the largest
    range (not the file)."""
    import os as _os
    if n_threads <= 0:
        n_threads = min(_os.cpu_count() or 1, 8)
    from . import native as native_mod
    if native_mod.get_lib() is None:
        # python fallback (CI only): a FULL whole-file decode — exact
        # (reads outside the ranges yield no hits downstream) but the
        # slowest possible path, so callers should avoid the index route
        # entirely without the native library (engine.pipeline gates its
        # decode-skip on get_lib() for this reason)
        bd = read_bam(path, native=False)
        return bd
    if header_meta is None:
        header_meta = read_bam_header_meta(path)
    ref_names, ref_lengths, header_text = header_meta
    lib = native_mod.get_lib()
    chunks = []
    with open(path, "rb") as fh:
        for vb, ve in vranges:
            cb, ub = vb >> 16, vb & 0xFFFF
            ce, ue = ve >> 16, ve & 0xFFFF
            if ue > 0:
                bsize, isize_last = _block_meta_at(fh, ce)
                end = ce + bsize
            else:
                end = ce
                isize_last = 0
            if end <= cb:
                continue
            fh.seek(cb)
            raw = np.frombuffer(fh.read(end - cb), np.uint8)
            payload = _inflate_bytes(raw, n_threads)
            beg = ub
            pend = len(payload) - isize_last + ue if ue > 0 else len(payload)
            window = np.ascontiguousarray(payload[beg:pend])
            bd, used = _parse_records_v2(lib, window, ref_names,
                                         ref_lengths, header_text,
                                         n_threads)
            if used != len(window):
                raise RuntimeError("voffset range not record-aligned in %s"
                                   % path)
            chunks.append(bd)
    if not chunks:
        return _empty_like_header(ref_names, ref_lengths, header_text)
    return concat_bam(chunks)


def _scan_end_hint(bai: BaiIndex, tid: int, hi: int) -> Optional[int]:
    """Approximate voffset where reads with start >= hi begin: the first
    linear entry for a window past hi (this tid), else the next tid's
    first entry.  Only a WINDOW-SIZING hint — may undershoot when a
    long-span read overlaps later windows (the caller keeps streaming
    until the exact stop condition), may overshoot slightly (harmless)."""
    lin = bai.linear[tid]
    w = (hi >> bai.min_shift) + 1
    if w < len(lin):
        tail = lin[w:]
        nz = tail[tail > 0]
        if nz.size:
            return int(nz[0])
    for t2 in range(tid + 1, len(bai.linear)):
        l2 = bai.linear[t2]
        nz = l2[l2 > 0]
        if nz.size:
            return int(nz[0])
    return None


def read_bam_starts(path: str, tid: int, lo: int, hi: int, bai: BaiIndex,
                    n_threads: int = 0, window_bytes: int = 2 * 1024 * 1024,
                    header_meta=None) -> BamData:
    """All reads of reference `tid` whose START (0-based pos) lies in
    [lo, hi) — the position-range engine shard unit.  The scan begins at
    the linear-index voffset for lo's window, sizes its FIRST decode
    window from the index's estimate of where the range ends, and stops
    at the first record past hi (reads are coordinate-sorted), so only
    the byte range that can contain the shard's reads is ever inflated."""
    import os as _os
    if n_threads <= 0:
        n_threads = min(_os.cpu_count() or 1, 8)
    if header_meta is None:
        header_meta = read_bam_header_meta(path)
    ref_names, ref_lengths, header_text = header_meta
    from . import native as native_mod
    lib = native_mod.get_lib()
    if lib is None:
        bd = read_bam(path, native=False)
        keep = (bd.refid == tid) & (bd.pos >= lo) & (bd.pos < hi)
        return bd.select(keep)
    sv = bai.start_voff(tid, lo)
    if sv is None:
        return _empty_like_header(ref_names, ref_lengths, header_text)
    cb, ub = sv >> 16, sv & 0xFFFF
    skip = ub
    kept = []
    carry = np.zeros(0, np.uint8)
    # first window spans the index's estimate of the range, later windows
    # (long-span overhang only) stay small; SEEK-based — only this range's
    # byte span is read from disk, memory bounded by one window
    hint = _scan_end_hint(bai, tid, hi)
    first_window = window_bytes
    if hint is not None:
        first_window = max((hint >> 16) + (1 << 16) - cb, 1 << 16)
    windows = [first_window]
    with open(path, "rb") as fh:
        fh.seek(0, 2)
        fsize = fh.tell()
        pos = cb
        while pos < fsize:
            wb = windows.pop(0) if windows else window_bytes
            want = min(wb, fsize - pos)
            fh.seek(pos)
            buf = fh.read(min(want + (1 << 16) + 64, fsize - pos))
            # largest block-aligned prefix covering >= want (or to EOF)
            off = 0
            n = len(buf)
            while off < n:
                try:
                    bsize, _ = bgzf._parse_block_header(buf, off)
                except Exception:
                    break
                if off + bsize > n:
                    break
                off += bsize
                if off >= want:
                    break
            if off == 0:
                break
            raw = np.frombuffer(buf[:off], np.uint8)
            payload = _inflate_bytes(raw, n_threads)
            data = payload[skip:]
            skip = 0
            if len(carry):
                data = np.concatenate([carry, data])
            bd, used = _parse_records_v2(lib, np.ascontiguousarray(data),
                                         ref_names, ref_lengths,
                                         header_text, n_threads)
            carry = data[used:].copy()
            pos += off
            if len(bd):
                keep = (bd.refid == tid) & (bd.pos >= lo) & (bd.pos < hi)
                if keep.all():
                    kept.append(bd)   # interior window: no copy needed
                elif keep.any():
                    kept.append(bd.select(keep))
                last_rid = int(bd.refid[-1])
                last_pos = int(bd.pos[-1])
                if last_rid > tid or last_rid < 0 or \
                        (last_rid == tid and last_pos >= hi):
                    break
    if not kept:
        return _empty_like_header(ref_names, ref_lengths, header_text)
    return concat_bam(kept)
