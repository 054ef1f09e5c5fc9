"""BAM and BAI writing (SAM/BAM specification, sections 4.2 and 5.2): the
records of a ReadSet laid out with numpy a chunk of reads at a time, each
chunk a matrix of rows as wide as its longest record whose ragged prefixes
a boolean mask lifts out in file order; whole records packed into BGZF
blocks; the index built from the records' virtual offsets."""

from __future__ import annotations

import struct

import numpy as np

from . import bgzf, index
from .reads import CHUNK, ReadSet


def header(cfg: dict, bam: dict) -> bytes:
    refs = cfg["header_contigs"]
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:%s\tLN:%d\n" % (n, ln) for n, ln in refs) + (
        "@RG\tID:%s\tSM:%s\tPL:ILLUMINA\n@PG\tID:%s\tPN:%s\n"
        % (bam["name_prefix"], cfg["sample"], bam["aligner"],
           bam["aligner"]))
    out = [b"BAM\x01", struct.pack("<i", len(text)), text.encode(),
           struct.pack("<i", len(refs))]
    for n, ln in refs:
        out.append(struct.pack("<i", len(n) + 1) + n.encode() + b"\x00" +
                   struct.pack("<i", ln))
    return b"".join(out)


def _le(vals, dtype: str) -> np.ndarray:
    """Little-endian bytes of each value, one row a value."""
    a = np.ascontiguousarray(np.asarray(vals).astype(dtype))
    return a.view(np.uint8).reshape(len(a), -1)


def names(rs: ReadSet, rows: slice) -> np.ndarray:
    """NUL-terminated read names `<prefix>.<fragment number>`, zero-padded
    to one width, as a byte matrix."""
    frag = rs.frag[rows].astype(np.int64)
    p = len(rs.name_prefix)
    out = np.empty((len(frag), p + 2 + rs.name_digits), np.uint8)
    out[:, :p] = np.frombuffer(rs.name_prefix.encode(), np.uint8)
    out[:, p] = ord(".")
    for d in range(rs.name_digits):
        out[:, p + rs.name_digits - d] = ord("0") + frag % 10
        frag //= 10
    out[:, -1] = 0
    return out


def records(rs: ReadSet, tid: int) -> tuple:
    """(the records' bytes in file order, each record's offset)."""
    n, L = len(rs), rs.L
    nl = len(rs.name_prefix) + 1 + rs.name_digits + 1
    n_ops = np.diff(rs.cig_off)
    size = 36 + nl + 4 * n_ops + (L + 1) // 2 + L + 8
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(size, out=starts[1:])
    body = np.empty(int(starts[-1]), np.uint8)
    bins = index.reg2bin(rs.pos, np.maximum(rs.end, rs.pos + 1))
    aux = np.empty((n, 8), np.uint8)
    aux[:, 0:3] = np.frombuffer(b"ASC", np.uint8)
    aux[:, 3] = rs.as_score
    aux[:, 4:7] = np.frombuffer(rs.aux2_tag.encode() + b"C", np.uint8)
    aux[:, 7] = rs.aux2
    head = np.dtype([("size", "<i4"), ("tid", "<i4"), ("pos", "<i4"),
                     ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                     ("n_cig", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                     ("mtid", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])
    for c0 in range(0, n, CHUNK):
        c1 = min(n, c0 + CHUNK)
        sl = slice(c0, c1)
        h = np.empty(c1 - c0, head)
        h["size"] = size[sl] - 4
        h["tid"] = tid
        h["pos"] = rs.pos[sl]
        h["l_name"] = nl
        h["mapq"] = rs.mapq[sl]
        h["bin"] = bins[sl]
        h["n_cig"] = n_ops[sl]
        h["flag"] = rs.flag[sl]
        h["l_seq"] = L
        h["mtid"] = tid
        h["mpos"] = rs.mate_pos[sl]
        h["tlen"] = rs.tlen[sl]
        seq = rs.seq[sl]
        if L % 2:
            seq = np.pad(seq, ((0, 0), (0, 1)))
        fixed = [h.view(np.uint8).reshape(c1 - c0, 36), names(rs, sl)]
        tail = [(seq[:, 0::2] << 4) | seq[:, 1::2], rs.qual[sl], aux[sl]]
        ops = n_ops[sl]
        classes = np.unique(ops).tolist()
        if len(classes) == 1:
            k = classes[0]
            cig = rs.cigar[rs.cig_off[c0]:rs.cig_off[c1]].reshape(-1, k)
            body[starts[c0]:starts[c1]] = np.hstack(
                fixed + [_le(cig, "<u4").reshape(c1 - c0, 4 * k)] +
                tail).reshape(-1)
            continue
        w = int(size[sl].max())
        M = np.zeros((c1 - c0, w), np.uint8)
        for k in classes:
            r = np.flatnonzero(ops == k)
            cig = rs.cigar[(rs.cig_off[c0 + r][:, None] +
                            np.arange(k)).reshape(-1)]
            mat = np.hstack([x[r] for x in fixed] +
                            [_le(cig, "<u4").reshape(len(r), 4 * k)] +
                            [x[r] for x in tail])
            M[r, :mat.shape[1]] = mat
        body[starts[c0]:starts[c1]] = M[np.arange(w)[None, :] <
                                        size[sl][:, None]]
    return body, starts[:-1]


def write(path: str, cfg: dict, bam: dict, rs: ReadSet, threads: int = 8,
          level: int = 1) -> int:
    """Writes path and path + ".bai"; returns the uncompressed size."""
    names = [n for n, _ in cfg["header_contigs"]]
    tid = names.index(cfg["contig"])
    head = header(cfg, bam)
    body, rec = records(rs, tid)
    data = np.concatenate([np.frombuffer(head, np.uint8), body])
    rec = rec + len(head)
    # the header in blocks of its own, then whole records
    cuts = np.concatenate([np.arange(0, len(head), bgzf.BLOCK_PAYLOAD),
                           len(head) + bgzf.record_blocks(
                               rec - len(head), len(body))])
    cuts, coff = bgzf.write(path, data, cuts, level=level, threads=threads)
    vb = bgzf.virtual_offsets(rec, cuts, coff)
    ve = bgzf.virtual_offsets(np.append(rec[1:], len(data)), cuts, coff)
    with open(path + ".bai", "wb") as fh:
        fh.write(index.bai(len(names), tid, rs.pos,
                           np.maximum(rs.end, rs.pos + 1), vb, ve))
    return len(data)
