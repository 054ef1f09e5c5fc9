"""Read -> variant allele assignment, vectorized (numpy host path).

Semantics mirror the reference mapper (reference phaser/read_variant_map.py):
  - BASEQ mask to N before anything else (:179-184)
  - CIGAR walk: M/X/= aligned, N splits segments, D emits placeholder,
    I recorded for splicing, S/H skipped (:191-231)
  - a variant is extracted iff its full REF span lies within one alignment
    segment (:236-258); deletions strip to ""; a bare "N" allele is dropped
  - template-length (isize) filter (:51); reads with N in CIGAR dropped
    when splice == 0 (:170)
  - one output row per (SAM line, variant); rows ordered by read stream
    order then variant-table order (the sliding-buffer order)

Design: a vectorized fast path computes per-base reference positions from the
CIGAR (segmented cumsums; identical math runs in the JAX device kernel in
phaser_tpu.kernels.alleles) and matches single-base variants by binary search.
Reads containing insertions and variants with multi-base alleles take an
exact string path (rare; reproduces the reference's insertion-splicing and
deletion-stripping behavior verbatim).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine.varmap import VariantTable
from ..io.bam import (BamData, CIGAR_OPS, OP_D, OP_EQ, OP_H, OP_I, OP_M, OP_N,
                      OP_P, OP_S, OP_X, SEQ_NIBBLE_CHARS)

# op class masks
_READ_CONSUME = np.zeros(16, bool)
_READ_CONSUME[[OP_M, OP_I, OP_S, OP_EQ, OP_X]] = True
_REF_CONSUME = np.zeros(16, bool)
_REF_CONSUME[[OP_M, OP_D, OP_N, OP_EQ, OP_X]] = True
_ALIGNED = np.zeros(16, bool)
_ALIGNED[[OP_M, OP_EQ, OP_X]] = True


@dataclass
class ContigHits:
    """Rows of the mapper output for one contig, in reference row order."""

    read_idx: np.ndarray                      # int64 into the BamData subset
    var_idx: np.ndarray                       # int64 into the VariantTable
    allele_code: np.ndarray                   # int16 nibble; -1 => see allele_strs
    allele_strs: Dict[int, str] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.read_idx)

    def allele_str(self, row: int) -> str:
        c = self.allele_code[row]
        if c >= 0:
            return SEQ_NIBBLE_CHARS[c]
        return self.allele_strs[row]


def expand_refpos(bd: BamData) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-base 1-based reference positions for all reads.

    Returns (refpos1, has_ins, ref_span):
      refpos1:  int64 array, one entry per base in bd.seq_flat; 0 where the
                base is not reference-aligned (I/S bases)
      has_ins:  bool per read — contains an insertion op
      ref_span: int64 per read — total reference bases consumed
    """
    ops = bd.cigar_flat
    lens = (ops >> 4).astype(np.int64)
    opc = (ops & 0xF).astype(np.int64)
    n_reads = len(bd)
    ops_per_read = np.diff(bd.cigar_off)
    op_read = np.repeat(np.arange(n_reads, dtype=np.int64), ops_per_read)

    read_adv = np.where(_READ_CONSUME[opc], lens, 0)
    ref_adv = np.where(_REF_CONSUME[opc], lens, 0)

    # exclusive segmented cumsums (reset at each read's first op)
    def seg_excl_cumsum(vals: np.ndarray) -> np.ndarray:
        tot0 = np.concatenate(([0], np.cumsum(vals)))
        return tot0[:-1] - tot0[bd.cigar_off[op_read]]

    read_before = seg_excl_cumsum(read_adv)
    ref_before = seg_excl_cumsum(ref_adv)

    refpos1 = np.zeros(bd.seq_off[-1], np.int32)
    amask = _ALIGNED[opc]
    if amask.any():
        a_lens = lens[amask]
        a_read = op_read[amask]
        a_rb = read_before[amask]
        a_gb = ref_before[amask]
        total = int(a_lens.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(a_lens)[:-1])), a_lens)
        base_idx = np.repeat(bd.seq_off[a_read] + a_rb, a_lens) + within
        gpos = np.repeat(bd.pos[a_read].astype(np.int64) + 1 + a_gb, a_lens) + within
        # a base past the read's own (a CIGAR longer than the sequence, a
        # sequence of `*`) does not exist: no position for it
        own = base_idx < np.repeat(bd.seq_off[a_read + 1], a_lens)
        refpos1[base_idx[own]] = gpos[own].astype(np.int32)

    has_ins = np.zeros(n_reads, bool)
    np.logical_or.at(has_ins, op_read, opc == OP_I)
    ref_span = np.zeros(n_reads, np.int64)
    np.add.at(ref_span, op_read, ref_adv)
    return refpos1, has_ins, ref_span


def _masked_codes(bd: BamData, baseq: int) -> np.ndarray:
    codes = bd.seq_flat.astype(np.int16)
    codes[bd.qual_flat < baseq] = 15
    return codes


def _exact_read_rows(pos1: int, seq: str, quals: np.ndarray,
                     cig: np.ndarray, vt: VariantTable,
                     lo: int, hi: int, baseq: int,
                     splice: bool) -> List[Tuple[int, str]]:
    """Reference split_read + identify_allele on one read; returns
    (var_idx, allele_str) for variants vt[lo:hi]."""
    opc = cig & 0xF
    if (not splice) and np.any(opc == OP_N):
        return []
    # BASEQ mask; bases past the read's own (a CIGAR longer than the
    # sequence, a sequence of `*`) read as N, so later ops keep their places
    bases = "".join(c if q >= baseq else "N" for c, q in zip(seq, quals))
    qlen = sum(int(c) >> 4 for c in cig if _READ_CONSUME[int(c) & 0xF])
    bases += "N" * (qlen - len(bases))
    segments = []  # (genome_start_off, pseudo, insertions)
    genome_start = 0
    genome_pos = 0
    read_pos = 0
    pseudo: List[str] = []
    insertions: Dict[int, str] = {}
    for c in cig:
        ln = int(c) >> 4
        op = int(c) & 0xF
        if op in (OP_M, OP_X, OP_EQ):
            pseudo.append(bases[read_pos:read_pos + ln])
            read_pos += ln
            genome_pos += ln
        elif op == OP_N:
            segments.append((genome_start, "".join(pseudo), insertions))
            genome_pos += ln
            genome_start = genome_pos
            pseudo = []
            insertions = {}
        elif op == OP_D:
            pseudo.append("D" * ln)
            genome_pos += ln
        elif op == OP_I:
            insertions[genome_pos - 1] = bases[read_pos:read_pos + ln]
            read_pos += ln
        elif op == OP_S:
            read_pos += ln
        # H/P/unknown: no-op
    segments.append((genome_start, "".join(pseudo), insertions))

    out: List[Tuple[int, str]] = []
    for vi in range(lo, hi):
        vpos = int(vt.pos[vi])
        rl = int(vt.ref_len[vi])
        for gstart, ps, ins in segments:
            map_start = pos1 + gstart
            rs = vpos - map_start
            re_ = vpos + rl - map_start
            if rs >= 0 and re_ <= len(ps):
                read_seq = ps[rs:re_]
                offset = 0
                for gp in range(rs, re_):
                    if gp in ins:
                        insert_pos = (gp - rs) + offset + 1
                        read_seq = read_seq[:insert_pos] + ins[gp] + read_seq[insert_pos:]
                        offset += len(ins[gp])
                read_seq = read_seq.replace("D", "")
                if read_seq != "N" and read_seq != "":
                    out.append((vi, read_seq))
                break
    return out


def _exact_rows_native(bd: BamData, sel: np.ndarray, vt: VariantTable,
                       baseq: int, splice: bool):
    """C++ exact path over the selected reads; returns [(read_idx, var_idx,
    allele_str)] or None when the native library is unavailable."""
    from ..io.native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    sub = bd.select(sel)
    n = len(sub)
    pos1 = np.ascontiguousarray(sub.pos.astype(np.int32) + 1)
    cig = np.ascontiguousarray(sub.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(sub.cigar_off, np.int64)
    seq = np.ascontiguousarray(sub.seq_flat, np.uint8)
    qual = np.ascontiguousarray(sub.qual_flat, np.uint8)
    soff = np.ascontiguousarray(sub.seq_off, np.int64)
    vpos = np.ascontiguousarray(vt.pos, np.int64)
    rlen = np.ascontiguousarray(vt.ref_len, np.int32)
    cap = max(int(sub.seq_off[-1]), 1024)
    acap = cap * 4
    ptr = ctypes.c_void_p
    while True:
        out_read = np.empty(cap, np.int64)
        out_var = np.empty(cap, np.int64)
        out_alleles = np.empty(acap, np.uint8)
        out_off = np.empty(cap + 1, np.int64)
        nr = lib.exact_assign(
            n, pos1.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
            coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
            qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr),
            baseq, 1 if splice else 0,
            len(vt), vpos.ctypes.data_as(ptr), rlen.ctypes.data_as(ptr),
            cap, out_read.ctypes.data_as(ptr), out_var.ctypes.data_as(ptr),
            acap, out_alleles.ctypes.data_as(ptr), out_off.ctypes.data_as(ptr))
        if nr >= 0:
            break
        cap *= 4
        acap *= 4
    blob = out_alleles.tobytes()
    rows = []
    for k in range(nr):
        rows.append((int(sel[out_read[k]]), int(out_var[k]),
                     blob[out_off[k]:out_off[k + 1]].decode()))
    return rows


def _map_simple_native(bd: BamData, vt: VariantTable, baseq: int,
                       splice: bool, keep_read: np.ndarray):
    """C++ fused mapper (map_simple in phaser_io.cc): per-read CIGAR walk +
    binary-search variant overlap + masked-nibble gather, multithreaded.
    Returns (read_idx, var_idx, codes, exact_sel) or None without the lib;
    exact_sel = sorted read indices that need the exact string path."""
    from ..io.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "map_simple_run"):
        return None
    import ctypes
    import os as _os
    ptr = ctypes.c_void_p
    n = len(bd)
    pos = np.ascontiguousarray(bd.pos, np.int32)
    cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(bd.cigar_off, np.int64)
    seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
    qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
    soff = np.ascontiguousarray(bd.seq_off, np.int64)
    keep = np.ascontiguousarray(keep_read, np.uint8)
    vpos = np.ascontiguousarray(vt.pos, np.int64)
    rlen = np.ascontiguousarray(vt.ref_len, np.int32)
    simple = np.ascontiguousarray(vt.is_simple, np.uint8)
    max_rl = int(rlen.max()) if len(rlen) else 0
    need_exact = np.empty(n, np.uint8)
    n_threads = min(_os.cpu_count() or 1, 8)
    h = lib.map_simple_run(
        n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
        coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
        qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr),
        keep.ctypes.data_as(ptr), len(vt), vpos.ctypes.data_as(ptr),
        rlen.ctypes.data_as(ptr), simple.ctypes.data_as(ptr), max_rl,
        baseq, 1 if splice else 0, need_exact.ctypes.data_as(ptr),
        n_threads)
    nr = lib.map_simple_n(h)
    out_r = np.empty(nr, np.int32)
    out_v = np.empty(nr, np.int32)
    out_c = np.empty(nr, np.uint8)
    lib.map_simple_fetch(h, out_r.ctypes.data_as(ptr),
                         out_v.ctypes.data_as(ptr),
                         out_c.ctypes.data_as(ptr))
    return (out_r.astype(np.int64), out_v.astype(np.int64),
            out_c.astype(np.int16), np.flatnonzero(need_exact))


def assign_alleles(bd: BamData, vt: VariantTable, *, baseq: int,
                   splice: bool = True, isize_cutoff: float = 0,
                   native: bool = True) -> ContigHits:
    """Compute all mapper rows for one contig's reads against its table."""
    n_reads = len(bd)
    if n_reads == 0 or len(vt) == 0:
        return ContigHits(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.int16))
    if np.any(np.diff(vt.pos) < 0):
        raise ValueError("variant table must be position-sorted")

    # isize filter (reference :51): abs(tlen) <= cutoff, or no cutoff
    keep_isize = np.ones(n_reads, bool)
    if isize_cutoff != 0:
        keep_isize &= np.abs(bd.tlen.astype(np.int64)) <= isize_cutoff

    native_res = (_map_simple_native(bd, vt, baseq, splice, keep_isize)
                  if native else None)
    if native_res is not None:
        f_read, f_vidx, f_code, exact_sel = native_res
        return _merge_rows(bd, vt, baseq, splice, f_read, f_vidx, f_code,
                           exact_sel)

    refpos1, has_ins, ref_span = expand_refpos(bd)
    codes = _masked_codes(bd, baseq)

    keep_read = keep_isize
    if not splice:
        # drop reads with N in cigar
        opc_all = (bd.cigar_flat & 0xF)
        ops_per_read = np.diff(bd.cigar_off)
        op_read = np.repeat(np.arange(n_reads), ops_per_read)
        hasN = np.zeros(n_reads, bool)
        np.logical_or.at(hasN, op_read, opc_all == OP_N)
        keep_read &= ~hasN

    simple_var = vt.is_simple
    exact_var_idx = np.flatnonzero(~simple_var)

    # ---------------- fast path: aligned single bases at simple-variant pos
    # Pregate with a genome-position membership mask so all large temporaries
    # are bools; only actual hit bases (a tiny fraction) become index arrays.
    spos = vt.pos
    max_pos = int(spos[-1]) if len(spos) else 0
    pos_mask = np.zeros(max_pos + 2, bool)
    pos_mask[spos] = True
    hit_full = pos_mask[np.minimum(refpos1, max_pos + 1)]
    hit_full &= refpos1 > 0
    # per-base read eligibility without materializing a per-base read index
    read_ok = keep_read & ~has_ins
    if not read_ok.all():
        # zero out bases of ineligible reads via their spans
        bad = np.flatnonzero(~read_ok)
        for ri in bad:
            hit_full[bd.seq_off[ri]:bd.seq_off[ri + 1]] = False
    b_idx = np.flatnonzero(hit_full)
    b_gpos = refpos1[b_idx].astype(np.int64)
    b_read = np.searchsorted(bd.seq_off, b_idx, side="right") - 1
    b_code = codes[b_idx]

    # match positions against simple variants (there may be several table
    # entries at one position)
    lo = np.searchsorted(spos, b_gpos, side="left")
    hi = np.searchsorted(spos, b_gpos, side="right")
    counts = hi - lo
    rows_r, rows_v, rows_c = [], [], []
    if len(counts):
        maxc = int(counts.max()) if len(counts) else 0
        for k in range(maxc):
            m = counts > k
            vi = lo[m] + k
            sm = simple_var[vi]
            rows_r.append(b_read[m][sm])
            rows_v.append(vi[sm])
            rows_c.append(b_code[m][sm])
    if rows_r:
        f_read = np.concatenate(rows_r)
        f_vidx = np.concatenate(rows_v)
        f_code = np.concatenate(rows_c)
    else:
        f_read = np.zeros(0, np.int64)
        f_vidx = np.zeros(0, np.int64)
        f_code = np.zeros(0, np.int16)
    # drop bare-N alleles (reference :255)
    nz = f_code != 15
    f_read, f_vidx, f_code = f_read[nz], f_vidx[nz], f_code[nz]

    # ---------------- exact path: reads with insertions (all their rows),
    # plus all reads overlapping non-simple variants
    exact_reads = set(np.flatnonzero(has_ins & keep_read).tolist())
    if len(exact_var_idx):
        # coarse overlap: reads whose ref window touches a non-simple variant
        starts = bd.pos.astype(np.int64) + 1
        ends = starts + ref_span  # one past
        for vi in exact_var_idx:
            vp = int(vt.pos[vi])
            rl = int(vt.ref_len[vi])
            cand = np.flatnonzero((starts <= vp + rl) & (ends + 1 >= vp) & keep_read)
            exact_reads.update(cand.tolist())
    exact_sel = np.asarray(sorted(exact_reads), np.int64)
    return _merge_rows(bd, vt, baseq, splice, f_read, f_vidx, f_code,
                       exact_sel, presorted=False)


def _merge_rows(bd: BamData, vt: VariantTable, baseq: int, splice: bool,
                f_read: np.ndarray, f_vidx: np.ndarray, f_code: np.ndarray,
                exact_sel: np.ndarray,
                presorted: bool = True) -> ContigHits:
    """Run the exact string path over exact_sel reads, merge with the fast
    rows, and return hits in canonical (read, variant) reference order."""
    e_rows_read: List[int] = []
    e_rows_vidx: List[int] = []
    e_rows_allele: List[str] = []

    if len(exact_sel):
        # per-read insertion flag for the skip rule (fast path owns simple
        # rows of non-insertion reads) — one vectorized gather over the
        # selected reads' CIGAR spans (was a per-read numpy-slice loop)
        sel = np.asarray(exact_sel, np.int64)
        starts = bd.cigar_off[sel]
        counts = bd.cigar_off[sel + 1] - starts
        total = int(counts.sum())
        if total:
            base = np.repeat(np.concatenate(
                [[0], np.cumsum(counts)[:-1]]), counts)
            pos = np.repeat(starts, counts) + (np.arange(total) - base)
            row_of = np.repeat(np.arange(len(sel)), counts)
            has_i = np.zeros(len(sel), bool)
            np.logical_or.at(has_i, row_of,
                             (bd.cigar_flat[pos] & 0xF) == OP_I)
        else:
            has_i = np.zeros(len(sel), bool)
        has_ins_sel: Dict[int, bool] = dict(
            zip(sel.tolist(), has_i.tolist()))
        native_rows = _exact_rows_native(bd, exact_sel, vt, baseq, splice)
        if native_rows is not None:
            for ri, vi, allele in native_rows:
                if not has_ins_sel[ri] and vt.is_simple[vi]:
                    continue  # fast path owns this row
                e_rows_read.append(ri)
                e_rows_vidx.append(vi)
                e_rows_allele.append(allele)
        else:
            spos = vt.pos
            for ri in exact_sel:
                p1 = int(bd.pos[ri]) + 1
                so, eo = bd.seq_off[ri], bd.seq_off[ri + 1]
                seq = "".join(SEQ_NIBBLE_CHARS[c] for c in bd.seq_flat[so:eo])
                quals = bd.qual_flat[so:eo]
                cig = bd.cigar_flat[bd.cigar_off[ri]:bd.cigar_off[ri + 1]]
                opc = (cig & 0xF).astype(np.int64)
                lens = (cig >> 4).astype(np.int64)
                span = int(lens[_REF_CONSUME[opc]].sum())
                vlo = int(np.searchsorted(spos, p1 - 1, side="left"))
                vhi = int(np.searchsorted(spos, p1 + span + 1, side="right"))
                for vi, allele in _exact_read_rows(p1, seq, quals, cig, vt,
                                                   vlo, vhi, baseq, splice):
                    if not has_ins_sel[int(ri)] and vt.is_simple[vi]:
                        continue  # fast path owns this row
                    e_rows_read.append(int(ri))
                    e_rows_vidx.append(vi)
                    e_rows_allele.append(allele)

    # ---------------- merge + canonical reference order
    if not e_rows_read and presorted:
        return ContigHits(f_read, f_vidx, f_code)
    all_read = np.concatenate([f_read, np.asarray(e_rows_read, np.int64)])
    all_vidx = np.concatenate([f_vidx, np.asarray(e_rows_vidx, np.int64)])
    all_code = np.concatenate([f_code, np.full(len(e_rows_read), -1, np.int16)])
    order = np.lexsort((all_vidx, all_read))
    hits = ContigHits(all_read[order], all_vidx[order], all_code[order])
    if e_rows_read:
        # locate exact rows post-sort
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        for k, (ri, vi, al) in enumerate(zip(e_rows_read, e_rows_vidx, e_rows_allele)):
            hits.allele_strs[int(inv[len(f_read) + k])] = al
    return hits


def hits_to_tsv(bd: BamData, vt: VariantTable, hits: ContigHits) -> str:
    """Render mapper rows as the reference TSV (read_variant_map.py:117)."""
    out = []
    for row in range(len(hits)):
        ri = hits.read_idx[row]
        vi = hits.var_idx[row]
        as_str = str(int(bd.as_score[ri])) if bd.has_as[ri] else ""
        out.append("\t".join([
            bd.names[ri].decode(), vt.unique_ids[vi], vt.rs_ids[vi],
            hits.allele_str(row), as_str, vt.geno_strings[vi],
            vt.maf_strs[vi]]))
    return "\n".join(out) + ("\n" if out else "")
