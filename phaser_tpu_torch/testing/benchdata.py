"""Chromosome-scale benchmark fixture: a multi-million-read BAM built
directly in numpy (vectorized record-byte assembly) + matching variant set.

Unlike tests/datagen.py (which favors exactness and feature coverage for
parity tests), this generator favors speed: fixed 100bp reads in two record
classes (plain 100M and spliced 50M nN 50M), uniform name lengths, no aux
tags. It emits a standards-conformant BAM (readable by the reference
toolchain) in seconds for 5M reads, so the bench can regenerate its fixture
from scratch on any machine.
"""

from __future__ import annotations

import os
import struct

import numpy as np

READ_LEN = 100
NAME_LEN = 9          # "r%08d" -> 9 chars + NUL
_NIBS = np.array([1, 2, 4, 8], np.uint8)        # A C G T
_CHARS = np.array(list("=ACMGRSVTWYHKDBN"))


def _names_bytes(idx: np.ndarray) -> np.ndarray:
    """Vectorized b"r%08d\\0" name matrix (n, NAME_LEN+1)."""
    n = len(idx)
    out = np.empty((n, NAME_LEN + 1), np.uint8)
    out[:, 0] = ord("r")
    rem = idx.astype(np.int64)
    for d in range(8):
        out[:, 8 - d] = ord("0") + rem % 10
        rem //= 10
    out[:, NAME_LEN] = 0
    return out


def _pack_class(pos: np.ndarray, idx: np.ndarray, codes: np.ndarray,
                quals: np.ndarray, cigars: np.ndarray) -> np.ndarray:
    """Assemble fixed-width BAM records (one class) into an (n, rec) matrix.

    codes/quals: (n, READ_LEN) uint8; cigars: (n, n_cigar) uint32.
    """
    n, n_cigar = len(pos), cigars.shape[1]
    l_seq = READ_LEN
    nbytes = (l_seq + 1) // 2
    block_size = 32 + (NAME_LEN + 1) + 4 * n_cigar + nbytes + l_seq
    rec = 4 + block_size
    out = np.zeros((n, rec), np.uint8)
    v32 = out.view(np.uint32)  # only safe for aligned columns; use manual LE

    def put_i32(col: int, vals: np.ndarray) -> None:
        b = vals.astype("<i4").view(np.uint8).reshape(n, 4)
        out[:, col:col + 4] = b

    put_i32(0, np.full(n, block_size, np.int32))
    put_i32(4, np.zeros(n, np.int32))              # refID
    put_i32(8, pos.astype(np.int32))               # 0-based pos
    out[:, 12] = NAME_LEN + 1                      # l_read_name
    out[:, 13] = 60                                # mapq
    # bin (2B) = 0
    out[:, 16] = n_cigar & 0xFF                    # n_cigar lo
    out[:, 17] = n_cigar >> 8
    # flag (2B) = 0
    put_i32(20, np.full(n, l_seq, np.int32))
    put_i32(24, np.full(n, -1, np.int32))          # next_refID
    put_i32(28, np.full(n, -1, np.int32))          # next_pos
    put_i32(32, np.zeros(n, np.int32))             # tlen
    out[:, 36:36 + NAME_LEN + 1] = _names_bytes(idx)
    co = 36 + NAME_LEN + 1
    out[:, co:co + 4 * n_cigar] = \
        cigars.astype("<u4").view(np.uint8).reshape(n, 4 * n_cigar)
    so = co + 4 * n_cigar
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    out[:, so:so + nbytes] = packed
    qo = so + nbytes
    out[:, qo:qo + l_seq] = quals
    del v32
    return out


def generate_bam(path: str, n_reads: int = 5_000_000,
                 contig_len: int = 200_000_000, frac_spliced: float = 0.1,
                 seed: int = 7, contig: str = "chr1") -> None:
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, contig_len - 2 * READ_LEN - 1000, n_reads))
    codes = _NIBS[rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)]
    quals = rng.integers(2, 41, (n_reads, READ_LEN), dtype=np.uint8)
    spliced = rng.random(n_reads) < frac_spliced
    idx = np.arange(n_reads, dtype=np.int64)

    # plain: 100M
    p_sel = ~spliced
    cig_p = np.full((int(p_sel.sum()), 1), (READ_LEN << 4) | 0, np.uint32)
    rec_p = _pack_class(pos[p_sel], idx[p_sel], codes[p_sel], quals[p_sel],
                        cig_p)
    # spliced: 50M <gap>N 50M
    s_sel = spliced
    ns = int(s_sel.sum())
    gaps = rng.integers(50, 800, ns).astype(np.uint32)
    cig_s = np.stack([
        np.full(ns, (50 << 4) | 0, np.uint32),
        (gaps << 4) | 3,
        np.full(ns, (50 << 4) | 0, np.uint32)], axis=1)
    rec_s = _pack_class(pos[s_sel], idx[s_sel], codes[s_sel], quals[s_sel],
                        cig_s)

    # interleave the two classes back into position order
    sizes = np.where(spliced, rec_s.shape[1], rec_p.shape[1]).astype(np.int64)
    offs = np.zeros(n_reads + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    body = np.empty(int(offs[-1]), np.uint8)
    from ..io.native import get_lib
    lib = get_lib()
    for sel, mat in ((p_sel, rec_p), (s_sel, rec_s)):
        rows = np.flatnonzero(sel)
        w = mat.shape[1]
        mat = np.ascontiguousarray(mat)
        if lib is not None and hasattr(lib, "scatter_rows"):
            import ctypes
            ptr = ctypes.c_void_p
            dsto = np.ascontiguousarray(offs[rows], np.int64)
            lib.scatter_rows(len(rows), dsto.ctypes.data_as(ptr),
                             mat.ctypes.data_as(ptr), w,
                             body.ctypes.data_as(ptr), 2)
        else:
            dst = offs[rows][:, None] + np.arange(w)
            body[dst.reshape(-1)] = mat.reshape(-1)

    sam_hdr = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:%s\tLN:%d\n"
               % (contig, contig_len)).encode()
    head = (b"BAM\x01" + struct.pack("<i", len(sam_hdr)) + sam_hdr +
            struct.pack("<i", 1) +
            struct.pack("<i", len(contig) + 1) + contig.encode() + b"\x00" +
            struct.pack("<i", contig_len))

    from ..io import bgzf
    with open(path, "wb") as fh:
        fh.write(bgzf.compress_bytes(head, level=1, eof=False))
        fh.write(bgzf.compress_bytes(body, level=1, eof=True))


def generate_variants(n_vars: int = 100_000, contig_len: int = 200_000_000,
                      seed: int = 8, contig: str = "chr1"):
    """Het SNP records in the list format build_variant_table consumes."""
    rng = np.random.default_rng(seed)
    vpos1 = np.sort(rng.choice(
        np.arange(1, contig_len - 1000, dtype=np.int64),
        n_vars, replace=False))
    ref_i = rng.integers(0, 4, n_vars)
    alt_i = (ref_i + rng.integers(1, 4, n_vars)) % 4
    bases = np.array(list("ACGT"))
    refs = bases[ref_i]
    alts = bases[alt_i]
    recs = []
    for i in range(n_vars):
        r, a = refs[i], alts[i]
        recs.append([contig, str(int(vpos1[i])), "rs%d" % i, r, a,
                     "100", "PASS", "AF=0.25", "GT", "0|1", [r, a]])
    return recs


def ensure_fixture(cache_dir: str, n_reads: int, n_vars: int,
                   contig_len: int = 200_000_000):
    """Create-or-reuse the cached chromosome-scale BAM; returns its path.
    Variant records are regenerated each call (cheap, deterministic)."""
    os.makedirs(cache_dir, exist_ok=True)
    tag = "chrscale_r%d_L%d" % (n_reads, contig_len)
    bam = os.path.join(cache_dir, tag + ".bam")
    if not os.path.exists(bam):
        tmp = bam + ".tmp"
        generate_bam(tmp, n_reads=n_reads, contig_len=contig_len)
        os.replace(tmp, bam)
    return bam
