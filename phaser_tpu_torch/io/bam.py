"""BAM reader/writer — native replacement for `samtools view` subprocesses.

The reference retrieves reads via `samtools view -h BAM 'chrom': | samtools
view -Sh -F 0x400 -f 2 -L bed -q MAPQ -` (reference phaser/phaser.py:1346)
and streams SAM text into its Cython mapper.  We decode BAM directly into
struct-of-arrays numpy buffers that feed the device allele-assignment kernel.

Sequence bases are kept as BAM 4-bit nibble codes throughout ("=ACMGRSVTWYHKDBN",
A=1 C=2 G=4 T=8 N=15) so that IUPAC ambiguity codes survive and compare exactly
like the reference's SAM-text characters.

This module is the pure-Python fallback; io/native provides the C++ fast path
with the same array contract.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import bgzf

BAM_MAGIC = b"BAM\x01"

SEQ_NIBBLE_CHARS = "=ACMGRSVTWYHKDBN"
CHAR_TO_NIBBLE = {c: i for i, c in enumerate(SEQ_NIBBLE_CHARS)}
NIB_A, NIB_C, NIB_G, NIB_T, NIB_N = 1, 2, 4, 8, 15

CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_AUX_SIZES = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
_AUX_INT_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}


class NameView:
    """Lazy read-name accessor over one concatenated blob + offsets.

    Materializing n Python bytes objects per decode window costs more than
    the whole native record parse; this keeps names as a single buffer and
    slices on demand. Supports int indexing, len, iteration, == with lists
    (tests), and ragged gather for BamData.select."""

    __slots__ = ("blob", "off")

    def __init__(self, blob: bytes, off: np.ndarray):
        self.blob = blob
        self.off = off

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i) -> bytes:
        return self.blob[self.off[i]:self.off[i + 1]]

    def __iter__(self):
        b, o = self.blob, self.off
        for i in range(len(o) - 1):
            yield b[o[i]:o[i + 1]]

    def __eq__(self, other):
        if isinstance(other, NameView):
            return self.blob == other.blob and np.array_equal(self.off, other.off)
        if isinstance(other, list):
            return list(self) == other
        return NotImplemented

    def gather(self, idx: np.ndarray) -> "NameView":
        o = self.off
        lens = o[idx + 1] - o[idx]
        new_off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        if total == 0:
            return NameView(b"", new_off)
        src = np.frombuffer(self.blob, np.uint8)
        if len(idx) > 4096:
            from . import native as native_mod
            lib = native_mod.get_lib()
            if lib is not None:
                import ctypes
                import os as _os
                ptr = ctypes.c_void_p
                out = np.empty(total, np.uint8)
                idx64 = np.ascontiguousarray(idx, np.int64)
                oc = np.ascontiguousarray(o, np.int64)
                lib.gather_ragged_u8(
                    len(idx64), idx64.ctypes.data_as(ptr),
                    src.ctypes.data_as(ptr), oc.ctypes.data_as(ptr),
                    new_off.ctypes.data_as(ptr), out.ctypes.data_as(ptr),
                    min(_os.cpu_count() or 1, 8))
                return NameView(out.tobytes(), new_off)
        within = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1], lens)
        pos = np.repeat(o[idx], lens) + within
        return NameView(src[pos].tobytes(), new_off)


_gather_n_threads = None


def _gather_threads() -> int:
    """Threads of the native row gather, asked of the OS once (the call
    costs about half a millisecond in a container)."""
    global _gather_n_threads
    if _gather_n_threads is None:
        import os
        _gather_n_threads = min(os.cpu_count() or 1, 8)
    return _gather_n_threads


@dataclass
class BamData:
    """Struct-of-arrays view of a BAM file (or a filtered subset)."""

    ref_names: List[str]
    ref_lengths: List[int]
    header_text: str
    # per-record scalars
    refid: np.ndarray          # int32
    pos: np.ndarray            # int32, 0-based leftmost
    mapq: np.ndarray           # uint8
    flag: np.ndarray           # uint16
    tlen: np.ndarray           # int32
    as_score: np.ndarray       # int32 (AS tag; 0 when absent)
    has_as: np.ndarray         # bool
    names: List[bytes] = field(default_factory=list)
    # ragged payloads
    cigar_flat: np.ndarray = None     # uint32 (len<<4|op)
    cigar_off: np.ndarray = None      # int64 [n+1]
    seq_flat: np.ndarray = None       # uint8 nibble codes, one per base
    qual_flat: np.ndarray = None      # uint8 phred (not +33)
    seq_off: np.ndarray = None        # int64 [n+1]
    # the allele dispatcher's span summary, written by the native decode
    # (None elsewhere): pos + the sum of ALL op lengths (int32), and bit 0
    # an I op, bit 1 an N op (uint8)
    span_end: Optional[np.ndarray] = None
    span_flags: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.refid)

    def slice_rows(self, a: int, b: int) -> "BamData":
        """Contiguous row range [a, b) as O(rows) array views/rebases —
        no per-base gather (select costs O(bases); coordinate-sorted
        region scans keep contiguous spans, the hot case)."""
        co, so = self.cigar_off, self.seq_off
        if isinstance(self.names, NameView):
            noff = self.names.off
            names = NameView(self.names.blob[noff[a]:noff[b]],
                             noff[a:b + 1] - noff[a])
        else:
            names = self.names[a:b]
        return BamData(
            ref_names=self.ref_names, ref_lengths=self.ref_lengths,
            header_text=self.header_text,
            refid=self.refid[a:b], pos=self.pos[a:b], mapq=self.mapq[a:b],
            flag=self.flag[a:b], tlen=self.tlen[a:b],
            as_score=self.as_score[a:b], has_as=self.has_as[a:b],
            names=names,
            cigar_flat=self.cigar_flat[co[a]:co[b]],
            cigar_off=co[a:b + 1] - co[a],
            seq_flat=self.seq_flat[so[a]:so[b]],
            qual_flat=self.qual_flat[so[a]:so[b]],
            seq_off=so[a:b + 1] - so[a],
            span_end=None if self.span_end is None else self.span_end[a:b],
            span_flags=(None if self.span_flags is None
                        else self.span_flags[a:b]),
        )

    def select(self, mask_or_idx) -> "BamData":
        idx = np.asarray(mask_or_idx)
        if idx.dtype == bool:
            mask = idx
            idx = np.flatnonzero(idx)
            # contiguous-run fast path: sorted-scan masks are runs
            if idx.size and idx[-1] - idx[0] + 1 == idx.size:
                return self.slice_rows(int(idx[0]), int(idx[-1]) + 1)
        co, so = self.cigar_off, self.seq_off
        native_lib = None
        if len(idx) > 4096:
            from . import native as native_mod
            native_lib = native_mod.get_lib()
        idx64 = np.ascontiguousarray(idx, np.int64)

        def gather_ragged(flat, off, new_off=None):
            if new_off is None:
                lens = off[idx + 1] - off[idx]
                new_off = np.zeros(len(idx) + 1, np.int64)
                np.cumsum(lens, out=new_off[1:])
            total = int(new_off[-1])
            if total == 0:
                return flat[:0], new_off
            if native_lib is not None and flat.dtype in (np.uint8,
                                                         np.uint32):
                import ctypes
                ptr = ctypes.c_void_p
                out = np.empty(total, flat.dtype)
                fn = (native_lib.gather_ragged_u32
                      if flat.dtype == np.uint32
                      else native_lib.gather_ragged_u8)
                fc = np.ascontiguousarray(flat)
                oc = np.ascontiguousarray(off, np.int64)
                fn(len(idx64), idx64.ctypes.data_as(ptr),
                   fc.ctypes.data_as(ptr), oc.ctypes.data_as(ptr),
                   new_off.ctypes.data_as(ptr), out.ctypes.data_as(ptr),
                   _gather_threads())
                return out, new_off
            lens = np.diff(new_off)
            within = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1], lens)
            src = np.repeat(off[idx], lens) + within
            return flat[src], new_off

        new_cig, new_co = gather_ragged(self.cigar_flat, co)
        new_seq, new_so = gather_ragged(self.seq_flat, so)
        new_qual, _ = gather_ragged(self.qual_flat, so, new_so)
        return BamData(
            ref_names=self.ref_names, ref_lengths=self.ref_lengths,
            header_text=self.header_text,
            refid=self.refid[idx], pos=self.pos[idx], mapq=self.mapq[idx],
            flag=self.flag[idx], tlen=self.tlen[idx],
            as_score=self.as_score[idx], has_as=self.has_as[idx],
            names=(self.names.gather(idx) if isinstance(self.names, NameView)
                   else [self.names[i] for i in idx]),
            cigar_flat=new_cig, cigar_off=new_co,
            seq_flat=new_seq, qual_flat=new_qual, seq_off=new_so,
            span_end=None if self.span_end is None else self.span_end[idx],
            span_flags=(None if self.span_flags is None
                        else self.span_flags[idx]),
        )


def _find_first_as(buf: bytes, start: int, end: int) -> Tuple[int, bool]:
    """Scan an aux region for the first AS tag (SAM-text order == aux order)."""
    off = start
    while off + 3 <= end:
        tag = buf[off:off + 2]
        typ = chr(buf[off + 2])
        off += 3
        if typ in _AUX_INT_FMT:
            size = _AUX_SIZES[typ]
            if tag == b"AS":
                return struct.unpack_from(_AUX_INT_FMT[typ], buf, off)[0], True
            off += size
        elif typ == "A":
            off += 1
        elif typ == "f":
            off += 4
        elif typ in ("Z", "H"):
            nul = buf.find(b"\x00", off, end)
            off = (nul + 1) if nul >= 0 else end
        elif typ == "B":
            sub = chr(buf[off])
            cnt = struct.unpack_from("<i", buf, off + 1)[0]
            off += 5 + _AUX_SIZES.get(sub, 1) * cnt
        else:
            break  # unknown type: stop scanning this record
    return 0, False


def read_bam(path_or_bytes, native: bool = True, n_threads: int = 0) -> BamData:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            raw = fh.read()
    if native:
        bd = _read_bam_native(raw, n_threads)
        if bd is not None:
            return bd
    data = bgzf.decompress_all(raw)
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8
    header_text = data[off:off + l_text].split(b"\x00")[0].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_lengths.append(l_ref)

    refid, pos, mapq, flag, tlen = [], [], [], [], []
    as_score, has_as, names = [], [], []
    cig_parts, seq_parts, qual_parts = [], [], []
    cigar_counts, seq_lens = [], []
    n = len(data)
    unpack_rec = struct.Struct("<iiBBHHHiiii").unpack_from
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        rec_end = off + block_size
        (rid, p, l_read_name, mq, _bin, n_cigar, fl, l_seq,
         _nrid, _npos, tl) = unpack_rec(data, off)
        o = off + 32
        names.append(data[o:o + l_read_name - 1])
        o += l_read_name
        cig = np.frombuffer(data, np.uint32, n_cigar, o)
        o += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(data, np.uint8, nbytes, o)
        o += nbytes
        seq = np.empty(nbytes * 2, np.uint8)
        seq[0::2] = packed >> 4
        seq[1::2] = packed & 0xF
        seq = seq[:l_seq]
        qual = np.frombuffer(data, np.uint8, l_seq, o)
        o += l_seq
        a, ha = _find_first_as(data, o, rec_end)
        refid.append(rid); pos.append(p); mapq.append(mq); flag.append(fl)
        tlen.append(tl); as_score.append(a); has_as.append(ha)
        cig_parts.append(cig); seq_parts.append(seq); qual_parts.append(qual)
        cigar_counts.append(n_cigar); seq_lens.append(l_seq)
        off = rec_end

    nrec = len(refid)
    cigar_off = np.zeros(nrec + 1, np.int64)
    np.cumsum(cigar_counts, out=cigar_off[1:])
    seq_off = np.zeros(nrec + 1, np.int64)
    np.cumsum(seq_lens, out=seq_off[1:])
    return BamData(
        ref_names=ref_names, ref_lengths=ref_lengths, header_text=header_text,
        refid=np.asarray(refid, np.int32), pos=np.asarray(pos, np.int32),
        mapq=np.asarray(mapq, np.uint8), flag=np.asarray(flag, np.uint16),
        tlen=np.asarray(tlen, np.int32),
        as_score=np.asarray(as_score, np.int32), has_as=np.asarray(has_as, bool),
        names=names,
        cigar_flat=(np.concatenate(cig_parts) if cig_parts else np.zeros(0, np.uint32)),
        cigar_off=cigar_off,
        seq_flat=(np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)),
        qual_flat=(np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8)),
        seq_off=seq_off,
    )


def _bamdata_from_handle(lib, h, ref_names=None, ref_lengths=None,
                         header_text=None) -> BamData:
    """Copy a native parse handle into numpy arrays (frees the handle)."""
    import ctypes
    try:
        n = lib.bam_n_records(h)
        n_refs = lib.bam_n_refs(h)
        refid = np.empty(n, np.int32)
        pos = np.empty(n, np.int32)
        mapq = np.empty(n, np.uint8)
        flag = np.empty(n, np.uint16)
        tlen = np.empty(n, np.int32)
        as_score = np.empty(n, np.int32)
        has_as = np.empty(n, np.uint8)
        cigar_off = np.empty(n + 1, np.int64)
        seq_off = np.empty(n + 1, np.int64)
        name_off = np.empty(n + 1, np.int64)
        cigar = np.empty(lib.bam_total_cigar(h), np.uint32)
        seq = np.empty(lib.bam_total_seq(h), np.uint8)
        qual = np.empty(lib.bam_total_seq(h), np.uint8)
        names_blob = np.empty(lib.bam_names_size(h), np.uint8)
        refnames_blob = np.empty(lib.bam_refnames_size(h), np.uint8)
        ref_lens = np.empty(max(n_refs, 0), np.int32)
        header = np.empty(lib.bam_header_size(h), np.uint8)
        ptr = ctypes.c_void_p
        lib.bam_fill(h, *(a.ctypes.data_as(ptr) for a in (
            refid, pos, mapq, flag, tlen, as_score, has_as, cigar_off,
            seq_off, name_off, cigar, seq, qual, names_blob, refnames_blob,
            ref_lens, header)))
    finally:
        lib.bam_free(h)
    nb = names_blob.tobytes()
    names = [nb[name_off[i]:name_off[i + 1]] for i in range(n)]
    if ref_names is None:
        ref_names = [r.decode() for r in
                     refnames_blob.tobytes().split(b"\x00")[:-1]]
        ref_lengths = ref_lens.tolist()
        header_text = header.tobytes().decode()
    return BamData(
        ref_names=ref_names, ref_lengths=ref_lengths,
        header_text=header_text,
        refid=refid, pos=pos, mapq=mapq, flag=flag, tlen=tlen,
        as_score=as_score, has_as=has_as.astype(bool), names=names,
        cigar_flat=cigar, cigar_off=cigar_off, seq_flat=seq, qual_flat=qual,
        seq_off=seq_off)


def _parse_records_v2(lib, data: np.ndarray, ref_names, ref_lengths,
                      header_text, n_threads: int) -> Tuple[BamData, int]:
    """Two-pass native record parse of a headerless byte window directly
    into numpy SoA buffers (parallel fill, lazy names). Returns
    (BamData, bytes_consumed) — a partial trailing record is not consumed."""
    import ctypes
    ptr = ctypes.c_void_p
    base = data.ctypes.data_as(ptr)
    size = len(data)
    n_c = ctypes.c_int64(0)
    tc_c = ctypes.c_int64(0)
    ts_c = ctypes.c_int64(0)
    tn_c = ctypes.c_int64(0)
    consumed = lib.bam_scan_v2(base, size, ctypes.byref(n_c),
                               ctypes.byref(tc_c), ctypes.byref(ts_c),
                               ctypes.byref(tn_c))
    n = n_c.value
    refid = np.empty(n, np.int32)
    pos = np.empty(n, np.int32)
    mapq = np.empty(n, np.uint8)
    flag = np.empty(n, np.uint16)
    tlen = np.empty(n, np.int32)
    as_score = np.empty(n, np.int32)
    has_as = np.empty(n, np.uint8)
    cigar_off = np.empty(n + 1, np.int64)
    seq_off = np.empty(n + 1, np.int64)
    name_off = np.empty(n + 1, np.int64)
    cigar = np.empty(tc_c.value, np.uint32)
    seq = np.empty(ts_c.value, np.uint8)
    qual = np.empty(ts_c.value, np.uint8)
    names_blob = np.empty(tn_c.value, np.uint8)
    span_end = np.empty(n, np.int32)
    span_flags = np.empty(n, np.uint8)
    lib.bam_parse_v2(
        base, size, n, *(a.ctypes.data_as(ptr) for a in (
            refid, pos, mapq, flag, tlen, as_score, has_as, cigar_off,
            seq_off, name_off, cigar, seq, qual, names_blob, span_end,
            span_flags)),
        n_threads)
    bd = BamData(
        ref_names=ref_names, ref_lengths=ref_lengths, header_text=header_text,
        refid=refid, pos=pos, mapq=mapq, flag=flag, tlen=tlen,
        as_score=as_score, has_as=has_as.astype(bool),
        names=NameView(names_blob.tobytes(), name_off),
        cigar_flat=cigar, cigar_off=cigar_off, seq_flat=seq, qual_flat=qual,
        seq_off=seq_off, span_end=span_end, span_flags=span_flags)
    return bd, consumed


def _read_bam_native(raw: bytes, n_threads: int = 0) -> Optional[BamData]:
    """C++ fast path: multithreaded BGZF inflate + parallel two-pass parse."""
    from . import native as native_mod
    lib = native_mod.get_lib()
    if lib is None:
        return None
    import ctypes
    import os as _os
    if n_threads <= 0:
        n_threads = min(_os.cpu_count() or 1, 8)
    total = lib.bgzf_total_size(raw, len(raw))
    if total < 0:
        return None
    ubuf = np.empty(total, np.uint8)
    got = lib.bgzf_decompress(raw, len(raw),
                              ubuf.ctypes.data_as(ctypes.c_void_p), n_threads)
    if got != total:
        return None
    consumed = ctypes.c_int64(0)
    h = lib.bam_header_only(ubuf.ctypes.data_as(ctypes.c_void_p), total,
                            ctypes.byref(consumed))
    if not h:
        return None
    hd = _bamdata_from_handle(lib, h)
    bd, _ = _parse_records_v2(lib, ubuf[consumed.value:], hd.ref_names,
                              hd.ref_lengths, hd.header_text, n_threads)
    return bd


_stream_tls = threading.local()


def stream_counts() -> Dict[str, int]:
    """What `iter_bam_stream` has done on the calling thread: records
    yielded (`reads`), compressed bytes taken (`bytes_in`) and bytes they
    inflated to (`bytes_out`).  Over a whole file the three are its
    records, its size and its uncompressed size."""
    return dict(zip(("reads", "bytes_in", "bytes_out"),
                    getattr(_stream_tls, "counts", (0, 0, 0))))


def iter_bam_stream(path: str, window_bytes: int = 256 * 1024 * 1024,
                    n_threads: int = 0):
    """Stream a BAM in bounded-memory windows of whole records.

    Yields BamData chunks (sharing ref_names/header) in file order; peak
    memory is ~one compressed window + its decompressed payload, instead of
    the whole file. Requires the native library.  Each window adds to this
    thread's `stream_counts`.
    """
    from . import bgzf as bgzf_mod
    from . import native as native_mod
    import ctypes
    import os as _os
    lib = native_mod.get_lib()
    if lib is None:
        raise RuntimeError("iter_bam_stream requires the native library")
    if n_threads <= 0:
        n_threads = min(_os.cpu_count() or 1, 8)

    with open(path, "rb") as fh:
        raw = np.frombuffer(fh.read(), np.uint8)
    offs = bgzf_mod.block_offsets(raw)
    offs.append(len(raw))

    ptr = ctypes.c_void_p
    carry = np.zeros(0, np.uint8)
    ref_names = None
    ref_lengths = None
    header_text = None
    bi = 0
    ubuf = np.zeros(0, np.uint8)   # grown once, reused across windows
    while bi < len(offs) - 1:
        # pick a block-aligned compressed window
        end_bi = bi
        while end_bi < len(offs) - 1 and \
                offs[end_bi + 1] - offs[bi] <= window_bytes:
            end_bi += 1
        end_bi = max(end_bi, bi + 1)
        cslice = raw[offs[bi]:offs[end_bi]]   # zero-copy view
        total = lib.bgzf_total_size(cslice.ctypes.data_as(ptr), len(cslice))
        need = max(total, 1) + len(carry)
        if len(ubuf) < need:
            ubuf = np.empty(need, np.uint8)
        ubuf[:len(carry)] = carry
        got = lib.bgzf_decompress(cslice.ctypes.data_as(ptr), len(cslice),
                                  ubuf[len(carry):].ctypes.data_as(ptr),
                                  n_threads)
        if got != total:
            raise RuntimeError("bgzf window decompress failed")
        data = ubuf[:len(carry) + total]
        if ref_names is None:
            consumed = ctypes.c_int64(0)
            h = lib.bam_header_only(data.ctypes.data_as(ptr), len(data),
                                    ctypes.byref(consumed))
            if not h:
                raise RuntimeError("not a BAM file")
            hd = _bamdata_from_handle(lib, h)
            ref_names = hd.ref_names
            ref_lengths = hd.ref_lengths
            header_text = hd.header_text
            data = data[consumed.value:]
        chunk, used = _parse_records_v2(lib, np.ascontiguousarray(data),
                                        ref_names, ref_lengths, header_text,
                                        n_threads)
        carry = data[used:].copy()
        bi = end_bi
        r, b_in, b_out = getattr(_stream_tls, "counts", (0, 0, 0))
        _stream_tls.counts = (r + len(chunk), b_in + len(cslice),
                              b_out + total)
        if len(chunk):
            yield chunk
    if len(carry):
        raise RuntimeError("trailing partial BAM record")


# ---------------------------------------------------------------------------
# Writer (used for test fixtures and by tooling)
# ---------------------------------------------------------------------------

@dataclass
class BamRecord:
    name: str
    refid: int
    pos: int          # 0-based
    mapq: int
    flag: int
    cigar: Sequence[Tuple[int, int]]   # (oplen, opcode)
    seq: str
    qual: Sequence[int]                # phred ints
    next_refid: int = -1
    next_pos: int = -1
    tlen: int = 0
    tags: Sequence[Tuple[str, str, object]] = ()   # (tag, type, value)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_bam(path: str, ref_names: Sequence[str], ref_lengths: Sequence[int],
              records: Sequence[BamRecord], header_text: Optional[str] = None) -> None:
    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            "@SQ\tSN:%s\tLN:%d\n" % (n, l) for n, l in zip(ref_names, ref_lengths))
    out = bytearray()
    out += BAM_MAGIC
    htext = header_text.encode()
    out += struct.pack("<i", len(htext))
    out += htext
    out += struct.pack("<i", len(ref_names))
    for nm, ln in zip(ref_names, ref_lengths):
        nb = nm.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    for r in records:
        name_b = r.name.encode() + b"\x00"
        cig = b"".join(struct.pack("<I", (ln << 4) | op) for ln, op in r.cigar)
        l_seq = len(r.seq)
        nib = [CHAR_TO_NIBBLE.get(c, 15) for c in r.seq.upper()]
        if l_seq % 2:
            nib.append(0)
        packed = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
        qual = bytes(r.qual) if r.qual else b"\xff" * l_seq
        end = r.pos + sum(ln for ln, op in r.cigar if op in (OP_M, OP_D, OP_N, OP_EQ, OP_X))
        if end <= r.pos:
            end = r.pos + 1
        aux = bytearray()
        for tag, typ, val in r.tags:
            aux += tag.encode() + typ.encode()
            if typ in _AUX_INT_FMT:
                aux += struct.pack(_AUX_INT_FMT[typ], val)
            elif typ == "f":
                aux += struct.pack("<f", val)
            elif typ == "A":
                aux += val.encode()
            elif typ == "Z":
                aux += str(val).encode() + b"\x00"
            else:
                raise ValueError("unsupported tag type %r" % typ)
        body = struct.pack(
            "<iiBBHHHiiii", r.refid, r.pos, len(name_b), r.mapq,
            _reg2bin(r.pos, end), len(r.cigar), r.flag, l_seq,
            r.next_refid, r.next_pos, r.tlen,
        ) + name_b + cig + packed + qual + bytes(aux)
        out += struct.pack("<i", len(body)) + body
    with bgzf.BgzfWriter(path) as w:
        w.write(bytes(out))


def cigar_to_string(cig: np.ndarray) -> str:
    return "".join("%d%s" % (int(c) >> 4, CIGAR_OPS[int(c) & 0xF]) for c in cig) or "*"


def record_to_sam_line(bd: BamData, i: int) -> str:
    """Render record i as a SAM text line (for reference-mapper interop tests)."""
    so, eo = bd.seq_off[i], bd.seq_off[i + 1]
    seq = "".join(SEQ_NIBBLE_CHARS[c] for c in bd.seq_flat[so:eo]) or "*"
    qual = "".join(chr(q + 33) for q in bd.qual_flat[so:eo]) or "*"
    cig = cigar_to_string(bd.cigar_flat[bd.cigar_off[i]:bd.cigar_off[i + 1]])
    fields = [
        bd.names[i].decode(), str(int(bd.flag[i])),
        bd.ref_names[bd.refid[i]] if bd.refid[i] >= 0 else "*",
        str(int(bd.pos[i]) + 1), str(int(bd.mapq[i])), cig,
        "=", "0", str(int(bd.tlen[i])), seq, qual,
    ]
    if bd.has_as[i]:
        fields.append("AS:i:%d" % int(bd.as_score[i]))
    return "\t".join(fields)
