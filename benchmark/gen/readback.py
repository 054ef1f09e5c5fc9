"""Reads the generator's files back, record by record, for the
benchmark's tests: BAM records, a BAI's or a tabix index's bins and linear
index, and which records a region query of the index reaches."""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from . import bgzf


def bam_records(path: str) -> Tuple[List[str], List[dict]]:
    """(reference names, records) of a BAM."""
    data = bgzf.read(path)
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM: %s" % path)
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", data, off)
        names.append(data[off + 4:off + 3 + ln].decode())
        off += 8 + ln
    recs = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        (tid, pos, l_name, mapq, bin_, n_cig, flag, l_seq, mtid, mpos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", data, off + 4)
        p = off + 36
        name = data[p:p + l_name - 1].decode()
        p += l_name
        cigar = list(struct.unpack_from("<%dI" % n_cig, data, p))
        p += 4 * n_cig
        packed = data[p:p + (l_seq + 1) // 2]
        seq = []
        for b in packed:
            seq += [b >> 4, b & 0xF]
        p += (l_seq + 1) // 2
        qual = list(data[p:p + l_seq])
        p += l_seq
        aux: Dict[str, int] = {}
        while p < off + 4 + size:
            tag, typ = data[p:p + 2].decode(), chr(data[p + 2])
            if typ != "C":
                raise ValueError("aux type %s" % typ)
            aux[tag] = data[p + 3]
            p += 4
        recs.append({"offset": off, "tid": tid, "pos": pos, "mapq": mapq,
                     "bin": bin_, "flag": flag, "mate_tid": mtid,
                     "mate_pos": mpos, "tlen": tlen, "name": name,
                     "cigar": cigar, "seq": seq[:l_seq], "qual": qual,
                     "aux": aux})
        off += 4 + size
    return names, recs


def _ref_index(buf: bytes, off: int):
    (n_bin,) = struct.unpack_from("<i", buf, off)
    off += 4
    bins = {}
    for _ in range(n_bin):
        b, n_chunk = struct.unpack_from("<Ii", buf, off)
        off += 8
        bins[b] = [struct.unpack_from("<QQ", buf, off + 16 * i)
                   for i in range(n_chunk)]
        off += 16 * n_chunk
    (n_intv,) = struct.unpack_from("<i", buf, off)
    off += 4
    lin = list(struct.unpack_from("<%dQ" % n_intv, buf, off))
    return bins, lin, off + 8 * n_intv


def bai(path: str) -> List[tuple]:
    """[(bins, linear)] of each reference of a BAI."""
    buf = open(path, "rb").read()
    if buf[:4] != b"BAI\x01":
        raise ValueError("not a BAI: %s" % path)
    (n_ref,) = struct.unpack_from("<i", buf, 4)
    off, out = 8, []
    for _ in range(n_ref):
        bins, lin, off = _ref_index(buf, off)
        out.append((bins, lin))
    return out


def tbi(path: str) -> Tuple[List[str], List[tuple]]:
    """(names, [(bins, linear)]) of a tabix index."""
    buf = bgzf.read(path)
    if buf[:4] != b"TBI\x01":
        raise ValueError("not a tabix index: %s" % path)
    (n_ref,) = struct.unpack_from("<i", buf, 4)
    (l_nm,) = struct.unpack_from("<i", buf, 32)
    names = buf[36:36 + l_nm].split(b"\x00")[:n_ref]
    off, out = 36 + l_nm, []
    for _ in range(n_ref):
        bins, lin, off = _ref_index(buf, off)
        out.append((bins, lin))
    return [n.decode() for n in names], out


def reg2bins(beg: int, end: int) -> List[int]:
    end -= 1
    out = [0]
    for lvl, first in ((1, 1), (2, 9), (3, 73), (4, 585), (5, 4681)):
        shift = 14 + 3 * (5 - lvl)
        out += list(range(first + (beg >> shift), first + (end >> shift) + 1))
    return out


def query(index: tuple, beg: int, end: int) -> List[Tuple[int, int]]:
    """Virtual-offset chunks that hold every record overlapping [beg, end)
    by the index (bins, lower-bounded by the linear index)."""
    bins, lin = index
    w = beg >> 14
    floor = lin[w] if w < len(lin) else (lin[-1] if lin else 0)
    return sorted((max(a, floor), b) for bn in reg2bins(beg, end)
                  for a, b in bins.get(bn, ()) if b > floor)
