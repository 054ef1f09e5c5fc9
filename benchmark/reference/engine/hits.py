"""Accumulate mapper rows into per-contig count/set structures.

Array-backed equivalent of process_mapping_result + the main-loop merge
(reference phaser/phaser.py:1287-1328, 556-586), replicating:
  - AS-score quantile cutoff applied per row (:1304)
  - allele matching against the individual's alleles; mismatches recorded as
    'other' (:1312-1324)
  - dict_variant_reads insertion order == global (bam, contig, row) first-seen
  - the read_vars merge at :576-581, whose condition tests a stale `variant`
    variable and therefore ASSIGNS (last BAM wins per read name) instead of
    extending
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..assign import ContigHits, NameView
from .varmap import VariantTable

OTHER = 2  # allele class for non-matching bases


@dataclass
class ContigRows:
    """Flattened, AS-filtered mapper rows for one contig (all BAMs)."""

    vt: VariantTable
    n_bams: int
    # per row, concatenated in (bam, file-row) order:
    bam_idx: np.ndarray          # int16
    var_idx: np.ndarray          # int64
    allele_idx: np.ndarray       # int8: 0/1 (ind allele) or OTHER
    uid: np.ndarray              # int64 read uid (per-contig, first-seen order)
    row_seq: np.ndarray          # int64 global sequence number of the row
    uid_names: List[bytes] = field(default_factory=list)

    def __len__(self):
        return len(self.var_idx)


def classify_alleles(hits: ContigHits, vt: VariantTable) -> np.ndarray:
    """allele_idx per row: position in the individual's alleles, or OTHER."""
    n = len(hits)
    out = np.full(n, OTHER, np.int8)
    codes = hits.allele_code
    fast = codes >= 0
    vi = hits.var_idx
    m0 = fast & (codes == vt.ind_codes[vi, 0]) & (vt.n_ind[vi] > 0)
    m1 = fast & ~m0 & (codes == vt.ind_codes[vi, 1]) & (vt.n_ind[vi] > 1)
    out[m0] = 0
    out[m1] = 1
    for row, s in hits.allele_strs.items():
        ind = vt.ind_alleles[int(vi[row])]
        out[row] = ind.index(s) if s in ind else OTHER
    return out


def build_contig_rows(vt: VariantTable,
                      per_bam: Sequence[Tuple[int, object, ContigHits]],
                      as_cutoffs: Dict[int, Optional[float]],
                      seq_offsets) -> ContigRows:
    """Concatenate per-bam mapper rows with AS filtering and global row seqs.

    per_bam: (bam_index, read chunk, hits) entries in (bam, file) order —
    one per bam for whole-file decode, several per bam when streaming.
    as_cutoffs: bam_index -> cutoff float or None (no cutoff in use).
    seq_offsets: either {bam_index: offset} (one entry per bam) or a list of
    per-entry global sequence offsets aligned with per_bam.
    """
    n_bams = max((b for b, _, _ in per_bam), default=-1) + 1
    bam_l, var_l, al_l, seq_l = [], [], [], []
    name_srcs = []   # per contributing entry: ("v", blob, off, ridx) | ("l", [bytes])
    for entry_i, (bam_index, chunk, hits) in enumerate(per_bam):
        cutoff = as_cutoffs.get(bam_index)
        n = len(hits)
        if n == 0:
            continue
        allele_idx = classify_alleles(hits, vt)
        if cutoff is not None:
            if not np.all(chunk.has_as[hits.read_idx]):
                raise ValueError(
                    "alignment-score cutoff in use but some reads lack AS tags "
                    "(the reference errors here too; set --as_q_cutoff 0)")
            keep = chunk.as_score[hits.read_idx] >= cutoff
        else:
            keep = np.ones(n, bool)
        kidx = np.flatnonzero(keep)
        off = (seq_offsets[entry_i] if isinstance(seq_offsets, (list, tuple))
               else seq_offsets[bam_index])
        bam_l.append(np.full(len(kidx), bam_index, np.int16))
        var_l.append(hits.var_idx[kidx])
        al_l.append(allele_idx[kidx])
        ridx = hits.read_idx[kidx]
        nm = chunk.names
        if isinstance(nm, NameView):
            name_srcs.append(("v", np.frombuffer(nm.blob, np.uint8),
                              nm.off, ridx))
        else:
            name_srcs.append(("l", [nm[int(i)] for i in ridx]))
        seq_l.append(off + np.arange(len(kidx), dtype=np.int64))

    if not var_l:
        return ContigRows(vt, n_bams, np.zeros(0, np.int16), np.zeros(0, np.int64),
                          np.zeros(0, np.int8), np.zeros(0, np.int64),
                          np.zeros(0, np.int64), [])
    bam_idx = np.concatenate(bam_l)
    var_idx = np.concatenate(var_l)
    allele_idx = np.concatenate(al_l)
    row_seq = np.concatenate(seq_l)
    # first-seen-order uid assignment per read name: one vectorized blob
    # gather into a fixed-width matrix + S-dtype (memcmp) unique — the
    # per-row python bytes extraction and object-array unique this
    # replaces were the hottest part of the accumulate stage
    lens_list = []
    for t in name_srcs:
        if t[0] == "v":
            _, _, noff, ridx = t
            lens_list.append((noff[ridx + 1] - noff[ridx]).astype(np.int64))
        else:
            lens_list.append(np.array([len(x) for x in t[1]], np.int64))
    W = max(int(max((int(l.max()) for l in lens_list if len(l)),
                    default=1)), 1)
    n_rows = int(sum(len(l) for l in lens_list))
    mat = np.zeros((n_rows, W), np.uint8)
    flat = mat.reshape(-1)
    r0 = 0
    for t, lens in zip(name_srcs, lens_list):
        k = len(lens)
        if t[0] == "v":
            _, blob, noff, ridx = t
            tot = int(lens.sum())
            if tot:
                cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
                within = np.arange(tot) - np.repeat(cum, lens)
                srcp = np.repeat(noff[ridx].astype(np.int64), lens) + within
                dst = np.repeat(np.arange(r0, r0 + k) * W, lens) + within
                flat[dst] = blob[srcp]
        else:
            for j, b in enumerate(t[1]):
                if len(b):
                    mat[r0 + j, :len(b)] = np.frombuffer(b, np.uint8)
        r0 += k
    names_s = mat.view("S%d" % W).reshape(-1)
    # unique's sort order (padded lexicographic) differs from the object
    # path's, but uids re-rank by FIRST-SEEN position, so grouping is all
    # that matters; padded equality == byte equality (names carry no NULs)
    uniq, first_pos, inv = np.unique(names_s, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_pos, kind="stable")
    rank_of_sorted = np.empty(len(uniq), np.int64)
    rank_of_sorted[order] = np.arange(len(uniq))
    uid = rank_of_sorted[inv]
    uid_names = [bytes(uniq[i]) for i in order]
    return ContigRows(vt, n_bams, bam_idx, var_idx, allele_idx, uid, row_seq,
                      uid_names)


@dataclass
class VariantReads:
    """Per-contig dict_variant_reads equivalent."""

    vt: VariantTable
    rows: ContigRows
    touched: np.ndarray            # sorted var indices with >=1 row
    first_seen: np.ndarray         # int64 per variant (min row_seq; -1 untouched)
    raw_counts: np.ndarray         # (n, 3) raw occurrence counts per allele class
    # unique (var, allele, uid) hits, lexsorted by (var, allele, uid):
    h_var: np.ndarray
    h_allele: np.ndarray
    h_uid: np.ndarray
    # CSR offsets into the unique-hit arrays for each (var, allele 0..2):
    set_off: np.ndarray            # (n, 4) -> [start0, start1, start2, end]
    # raw haplo rows (allele 0/1, bam not excluded), stably sorted by
    # (var, allele, bam), original row order within groups:
    hap_var: np.ndarray
    hap_allele: np.ndarray
    hap_bam: np.ndarray
    hap_uid: np.ndarray
    hap_off: Dict[Tuple[int, int, int], Tuple[int, int]] = None  # (v,a,b) -> span
    # read_vars (last-bam-wins): matched rows only
    rv_uid: np.ndarray = None      # per surviving matched row
    rv_var: np.ndarray = None
    rv_read_rank: np.ndarray = None  # first-seen rank of the read (matched rows)

    def unique_count(self, v: int, a: int) -> int:
        return int(self.set_off[v, a + 1] - self.set_off[v, a])

    def read_set(self, v: int, a: int) -> np.ndarray:
        return self.h_uid[self.set_off[v, a]:self.set_off[v, a + 1]]

    def haplo_list(self, v: int, a: int, b: int) -> Optional[np.ndarray]:
        """Raw (dup-preserving, row-ordered) haplo read list, or None when the
        bam key was never created (dict membership semantics)."""
        span = self.hap_off.get((v, a, b))
        if span is None:
            return None
        return self.hap_uid[span[0]:span[1]]


def build_variant_reads(rows: ContigRows,
                        haplo_count_bam_exclude: Sequence[int]) -> VariantReads:
    vt = rows.vt
    n = len(vt)
    nr = len(rows)
    first_seen = np.full(n, np.iinfo(np.int64).max, np.int64)
    if nr:
        np.minimum.at(first_seen, rows.var_idx, rows.row_seq)
    first_seen[first_seen == np.iinfo(np.int64).max] = -1
    touched = np.flatnonzero(first_seen >= 0)

    raw = np.zeros((n, 3), np.int64)
    if nr:
        np.add.at(raw, (rows.var_idx, rows.allele_idx.astype(np.int64)), 1)

    # unique hits
    if nr:
        key = np.lexsort((rows.uid, rows.allele_idx, rows.var_idx))
        hv = rows.var_idx[key]
        ha = rows.allele_idx[key].astype(np.int64)
        hu = rows.uid[key]
        dup = np.zeros(nr, bool)
        dup[1:] = (hv[1:] == hv[:-1]) & (ha[1:] == ha[:-1]) & (hu[1:] == hu[:-1])
        hv, ha, hu = hv[~dup], ha[~dup], hu[~dup]
    else:
        hv = ha = hu = np.zeros(0, np.int64)
    set_off = np.zeros((n, 4), np.int64)
    comb = hv * 4 + ha
    for a in range(3):
        set_off[:, a] = np.searchsorted(comb, np.arange(n) * 4 + a)
    set_off[:, 3] = np.searchsorted(comb, np.arange(n) * 4 + 3)

    # haplo rows (matched rows, allele<2, bam not excluded)
    excl = set(haplo_count_bam_exclude)
    if nr:
        hm = (rows.allele_idx < 2)
        if excl:
            hm &= ~np.isin(rows.bam_idx, list(excl))
        hvx = rows.var_idx[hm]
        hax = rows.allele_idx[hm].astype(np.int64)
        hbx = rows.bam_idx[hm].astype(np.int64)
        hux = rows.uid[hm]
        korder = np.lexsort((np.arange(len(hvx)), hbx, hax, hvx))
        hvx, hax, hbx, hux = hvx[korder], hax[korder], hbx[korder], hux[korder]
    else:
        hvx = hax = hbx = hux = np.zeros(0, np.int64)
    hap_off: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
    if len(hvx):
        gkey = (hvx * 2 + hax) * max(rows.n_bams, 1) + hbx
        starts = np.flatnonzero(np.concatenate(([True], gkey[1:] != gkey[:-1])))
        ends = np.concatenate((starts[1:], [len(gkey)]))
        for s, e in zip(starts, ends):
            hap_off[(int(hvx[s]), int(hax[s]), int(hbx[s]))] = (int(s), int(e))

    # read_vars: matched rows; keep rows from each read's LAST bam
    if nr:
        m = rows.allele_idx < 2
        m_uid = rows.uid[m]
        m_var = rows.var_idx[m]
        m_bam = rows.bam_idx[m].astype(np.int64)
        m_seq = rows.row_seq[m]
        n_uids = len(rows.uid_names)
        last_bam = np.full(n_uids, -1, np.int64)
        np.maximum.at(last_bam, m_uid, m_bam)
        keep = m_bam == last_bam[m_uid]
        rv_uid = m_uid[keep]
        rv_var = m_var[keep]
        rv_seq = m_seq[keep]
        # read first-seen rank over matched rows (read_vars key order)
        first_row = np.full(n_uids, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first_row, m_uid, m_seq)
        ranks_sorted = np.argsort(
            first_row[np.unique(m_uid)], kind="stable")
        uniq_uids = np.unique(m_uid)
        uid_rank = np.full(n_uids, -1, np.int64)
        uid_rank[uniq_uids[ranks_sorted]] = np.arange(len(uniq_uids))
        rv_read_rank = uid_rank[rv_uid]
        # rows within a read stay in file order
        order = np.lexsort((rv_seq, rv_read_rank))
        rv_uid, rv_var, rv_read_rank = rv_uid[order], rv_var[order], rv_read_rank[order]
    else:
        rv_uid = rv_var = rv_read_rank = np.zeros(0, np.int64)

    vr = VariantReads(
        vt=vt, rows=rows, touched=touched, first_seen=first_seen,
        raw_counts=raw, h_var=hv, h_allele=ha, h_uid=hu, set_off=set_off,
        hap_var=hvx, hap_allele=hax, hap_bam=hbx, hap_uid=hux,
        hap_off=hap_off, rv_uid=rv_uid, rv_var=rv_var,
        rv_read_rank=rv_read_rank)
    return vr


def noise_terms(vr: VariantReads) -> Tuple[int, int]:
    """(base_match_count, base_mismatch_count) contributions of this contig
    (reference phaser/phaser.py:611-624): raw occurrence counts, only
    variants whose mismatch fraction is < 5%."""
    matches = vr.raw_counts[:, 0] + vr.raw_counts[:, 1]
    mis = vr.raw_counts[:, 2]
    tot = matches + mis
    use = (matches > 0) & (mis.astype(float) / np.maximum(tot, 1) < 0.05)
    return int(matches[use].sum()), int(mis[use].sum())
