"""Variant-connection graph: a frozen copy of the host route of
phaser_tpu_torch/engine/connections.py, with the device pair counting left
out.  `p_dtype` rounds the conflicting-configuration p-values to a lower
precision: the lower-precision control of the benchmark's comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
from scipy.stats import binom

from .hits import VariantReads

@dataclass
class ContigConnections:
    """All tested pairs for one contig, canonically ordered."""

    # per pair, oriented (a, b) = (earlier, later) overlap-key rank:
    var_a: np.ndarray
    var_b: np.ndarray
    c_supporting: np.ndarray       # int64
    c_total: np.ndarray
    p_value: np.ndarray            # float64 conflicting_config_p
    p_display: List = None         # int 0/1 or float, reference typing
    phase_concordant: List = None  # 1, 0, or "."
    chosen_config: np.ndarray = None  # int8: 0, 1, -1
    pruned: np.ndarray = None      # bool (p < cc_threshold)
    var_rank: np.ndarray = None    # overlap-key rank per variant (-1 = no key)
    # post-prune adjacency (variant -> set of neighbors), insertion order
    # irrelevant (consumers use ranks):
    adj: Dict[int, Set[int]] = field(default_factory=dict)
    # allele edges: (v, a) -> set of (w, b); keys exist (possibly empty) for
    # every endpoint of every surviving pair:
    allele_conn: Dict[Tuple[int, int], Set[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def n_pairs(self) -> int:
        return len(self.var_a)


def _pair_combos(uid: np.ndarray, var: np.ndarray, allele: Optional[np.ndarray]):
    """Enumerate within-read pairs. Input sorted by uid. Returns
    (vi, vj, ai, aj) with vi<vj (table order), one tuple per (read, hit-pair).
    With allele=None returns only (vi, vj)."""
    if len(uid) == 0:
        z = np.zeros(0, np.int64)
        return (z, z, z, z) if allele is not None else (z, z)
    starts = np.flatnonzero(np.concatenate(([True], uid[1:] != uid[:-1])))
    counts = np.diff(np.concatenate((starts, [len(uid)])))
    vi_l, vj_l, ai_l, aj_l = [], [], [], []
    for k in np.unique(counts):
        if k < 2:
            continue
        sel = starts[counts == k]
        # index templates for combinations(k, 2)
        ii, jj = np.triu_indices(k, 1)
        base = sel[:, None]
        I = (base + ii[None, :]).ravel()
        J = (base + jj[None, :]).ravel()
        v1, v2 = var[I], var[J]
        if allele is not None:
            a1, a2 = allele[I], allele[J]
        swap = v1 > v2
        lo = np.where(swap, v2, v1)
        hi = np.where(swap, v1, v2)
        keep = lo != hi
        vi_l.append(lo[keep])
        vj_l.append(hi[keep])
        if allele is not None:
            al = np.where(swap, a2, a1)
            ah = np.where(swap, a1, a2)
            ai_l.append(al[keep])
            aj_l.append(ah[keep])
    if not vi_l:
        z = np.zeros(0, np.int64)
        return (z, z, z, z) if allele is not None else (z, z)
    vi = np.concatenate(vi_l)
    vj = np.concatenate(vj_l)
    if allele is None:
        return vi, vj
    return vi, vj, np.concatenate(ai_l), np.concatenate(aj_l)


def compute_overlap_ranks(vr: VariantReads) -> np.ndarray:
    """dict_variant_overlap key order: first appearance of a variant in a
    multi-distinct-variant read, over reads in read_vars key order."""
    n = len(vr.vt)
    rank = np.full(n, -1, np.int64)
    uid, var = vr.rv_uid, vr.rv_var
    if len(uid) == 0:
        return rank
    # distinct var count per read
    order = np.lexsort((var, uid))
    u_s, v_s = uid[order], var[order]
    new_pair = np.concatenate(([True], (u_s[1:] != u_s[:-1]) | (v_s[1:] != v_s[:-1])))
    distinct = np.zeros(int(uid.max()) + 1, np.int64)
    np.add.at(distinct, u_s[new_pair], 1)
    multi = distinct[uid] >= 2
    mv = var[multi]
    # rv rows are already in (read_rank, file order); first occurrence wins
    seen_first = np.full(n, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(seen_first, mv, np.arange(len(mv), dtype=np.int64))
    keyed = np.flatnonzero(seen_first < np.iinfo(np.int64).max)
    order2 = np.argsort(seen_first[keyed], kind="stable")
    rank[keyed[order2]] = np.arange(len(keyed))
    return rank



def build_connections(vr: VariantReads, noise_e: float,
                      cc_threshold: float,
                      p_dtype=np.float64) -> ContigConnections:
    """phaser_tpu engine/connections.py:175-308, pairs counted on the
    host."""
    vt = vr.vt
    var_rank = compute_overlap_ranks(vr)

    # ---- pair universe from read_vars co-occurrence
    uorder = np.argsort(vr.rv_uid, kind="stable")
    pv_i, pv_j = _pair_combos(vr.rv_uid[uorder], vr.rv_var[uorder], None)
    if len(pv_i):
        pk = pv_i * len(vt) + pv_j
        uniq_pk = np.unique(pk)
        P = len(uniq_pk)
        p_lo = uniq_pk // len(vt)
        p_hi = uniq_pk % len(vt)
    else:
        P = 0
        p_lo = p_hi = np.zeros(0, np.int64)

    # ---- counts over deduplicated hits (all allele classes)
    counts = np.zeros((P, 3, 3), np.int64)
    if P:
        horder = np.argsort(vr.h_uid, kind="stable")
        hv, ha, hu = vr.h_var[horder], vr.h_allele[horder], vr.h_uid[horder]
        ci, cj, cai, caj = _pair_combos(hu, hv, ha)
        if len(ci):
            ck = ci * len(vt) + cj
            pidx = np.searchsorted(uniq_pk, ck)
            inuni = (pidx < P) & (uniq_pk[np.minimum(pidx, P - 1)] == ck)
            np.add.at(counts, (pidx[inuni], cai[inuni], caj[inuni]), 1)

    config_a = counts[:, 0, 0] + counts[:, 1, 1]
    config_b = counts[:, 0, 1] + counts[:, 1, 0]
    other = (counts[:, 2, 0] + counts[:, 2, 1] + counts[:, 0, 2] +
             counts[:, 1, 2] + counts[:, 2, 2])
    c_supporting = np.maximum(config_a, config_b)
    c_total = config_a + config_b + other
    chosen = np.where(config_a > config_b, 0,
                      np.where(config_a < config_b, 1, -1)).astype(np.int8)

    # p-values: always host scipy, because variant_connections.txt prints
    # every pair's p at full float64 precision
    p_value = np.ones(P, np.float64)
    p_value[c_supporting == 0] = 0.0
    do_test = (c_supporting > 0) & (c_total - c_supporting > 0)
    if do_test.any():
        p_success = 1 - ((6 * noise_e) + (10 * noise_e ** 2))
        p_value[do_test] = binom.cdf(c_supporting[do_test], c_total[do_test],
                                     p_success)
        p_value = p_value.astype(p_dtype).astype(np.float64)
    pruned = p_value < cc_threshold
    # display objects: the reference assigns int 0 / int 1 outside the test
    # branch (:1645-1652), floats from binom.cdf inside it
    p_display = [
        (float(p_value[k]) if do_test[k] else int(p_value[k]))
        for k in range(P)]

    # ---- orientation: variant_a = earlier overlap-key rank
    ra, rb = var_rank[p_lo], var_rank[p_hi]
    swap = ra > rb
    va = np.where(swap, p_hi, p_lo)
    vb = np.where(swap, p_lo, p_hi)

    # phase concordance (test_variant_connection :1607-1620): per-variant
    # phase indices precompute once (O(n)), the per-pair loop reduces to
    # vectorized selects
    n_vt = len(vt)
    dash = np.ones(n_vt, bool)
    idx0 = np.zeros(n_vt, np.int8)
    idx1 = np.zeros(n_vt, np.int8)
    for v in np.unique(np.concatenate([p_lo, p_hi])) if P else []:
        v = int(v)
        pa = vt.phases[v]
        if "-" in pa:
            continue
        ind = vt.ind_alleles[v]
        dash[v] = False
        idx0[v] = pa.index(ind[0])
        idx1[v] = pa.index(ind[1])
    if P:
        ok = ~dash[va] & ~dash[vb]
        gt = config_a > config_b
        lt = config_a < config_b
        pc_num = np.where(gt, idx0[va] == idx0[vb],
                          idx1[va] == idx0[vb]).astype(np.int64)
        use = ok & (gt | lt)
        phase_concordant: List = [
            int(pc_num[k]) if use[k] else "." for k in range(P)]
    else:
        phase_concordant = []

    # ---- post-prune adjacency + allele edges
    adj: Dict[int, Set[int]] = {}
    allele_conn: Dict[Tuple[int, int], Set[Tuple[int, int]]] = {}
    for k in np.flatnonzero(~pruned):
        a, b = int(va[k]), int(vb[k])
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
        for key in ((a, 0), (a, 1), (b, 0), (b, 1)):
            allele_conn.setdefault(key, set())
        ch = int(chosen[k])
        if ch == 0:
            allele_conn[(a, 0)].add((b, 0))
            allele_conn[(b, 0)].add((a, 0))
            allele_conn[(a, 1)].add((b, 1))
            allele_conn[(b, 1)].add((a, 1))
        elif ch == 1:
            allele_conn[(a, 0)].add((b, 1))
            allele_conn[(b, 0)].add((a, 1))
            allele_conn[(a, 1)].add((b, 0))
            allele_conn[(b, 1)].add((a, 0))

    # canonical file order: (rank_a, rank_b)
    order = np.lexsort((var_rank[vb], var_rank[va]))
    return ContigConnections(
        var_a=va[order], var_b=vb[order],
        c_supporting=c_supporting[order], c_total=c_total[order],
        p_value=p_value[order],
        p_display=[p_display[i] for i in order],
        phase_concordant=[phase_concordant[i] for i in order],
        chosen_config=chosen[order], pruned=pruned[order],
        var_rank=var_rank, adj=adj, allele_conn=allele_conn)
