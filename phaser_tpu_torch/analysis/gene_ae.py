"""Gene-level haplotypic expression (phASER Gene AE).

Parity implementation of reference phaser_gene_ae/phaser_gene_ae.py:
feature interval stabbing (numpy sorted-starts + cummax-ends index instead of
an interval tree), block-phase mapping onto gene haplotypes, unique-read
deduplication via read-index sets, best-covered-unphased fallback, and the
log2 aFC with inf/-inf guards.

The reference's hot loop is a pandas `iterrows` over every haplotype row x an
interval-tree stab per row (phaser_gene_ae.py:102-110 — SURVEY hot loop #4).
Here the row columns are materialized once as flat lists, every row's feature
query runs as one batched `searchsorted` per contig, and the unique-read
deduplication is memoized per (row, in-feature variant subset) — a block fully
contained in all its genes (the overwhelmingly common case) does its set
union exactly once however many features it hits.

The haplotypic counts are read by utils.table, which types their columns
as phaser_tpu's pandas.read_csv does (so the outputs are the same bytes);
no pandas is needed.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..utils.table import read_tsv


def zero_divide(a, b) -> float:
    if b == 0:
        return float("inf")
    return float(a) / float(b)


def zero_log(value, base) -> float:
    if value == 0:
        return float("-inf")
    return math.log(value, base)


@dataclass
class _Feature:
    chrom: str
    start: int
    stop: int
    name: str


class _IntervalIndex:
    """start-sorted intervals + running-max end for contiguous candidate
    ranges; query semantics match intervaltree: begin < qend and end > qbeg."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray, ids: np.ndarray):
        order = np.argsort(starts, kind="stable")
        self.starts = starts[order]
        self.ends = ends[order]
        self.ids = ids[order]
        self.cummax_end = np.maximum.accumulate(self.ends)

    def query(self, qbeg: int, qend: int) -> np.ndarray:
        hi = np.searchsorted(self.starts, qend, side="left")
        lo = np.searchsorted(self.cummax_end, qbeg, side="right")
        if lo >= hi:
            return self.ids[:0]
        cand = slice(lo, hi)
        mask = self.ends[cand] > qbeg
        return self.ids[cand][mask]


def run_gene_ae(haplotypic_counts: str, features: str, o: str,
                id_separator: str = "_", gw_cutoff: float = 0.9,
                min_cov: int = 0, min_haplo_maf: float = 0,
                log=print) -> None:
    if min_haplo_maf < 0 or min_haplo_maf > 0.5:
        raise ValueError("invalid value for min_haplo_maf")

    feats: List[_Feature] = []
    by_chrom: Dict[str, List[int]] = {}
    with open(features) as fh:
        for line in fh:
            cols = line.rstrip().split("\t")
            if len(cols) < 4:
                continue
            f = _Feature(cols[0], int(cols[1]), int(cols[2]), cols[3])
            by_chrom.setdefault(f.chrom, []).append(len(feats))
            feats.append(f)
    index: Dict[str, _IntervalIndex] = {}
    for chrom, ids in by_chrom.items():
        index[chrom] = _IntervalIndex(
            np.asarray([feats[i].start for i in ids]),
            np.asarray([feats[i].stop for i in ids]),
            np.asarray(ids))

    df_master = read_tsv(haplotypic_counts)
    if "bam" not in df_master:
        raise ValueError("phaser_gene_ae requires phASER v1.0.0+ results "
                         "(missing 'bam' column)")

    out = open(o, "w")
    out.write("\t".join(["contig", "start", "stop", "name", "aCount", "bCount",
                         "totalCount", "log2_aFC", "n_variants", "variants",
                         "gw_phased", "bam"]) + "\n")

    # canonical bam order: first appearance (reference: set iteration)
    bam_order = list(dict.fromkeys(df_master["bam"]))
    for xbam in bam_order:
        df = df_master.where("bam", xbam)
        state = {i: {"aCount": 0, "bCount": 0, "variants": [],
                     "unphased_aCount": 0, "unphased_bCount": 0,
                     "unphased_variants": ""} for i in range(len(feats))}
        maf_filtered = 0
        has_maf_col = "max_haplo_maf" in df

        # flat column lists once (iterrows builds a Series per row)
        n_rows = len(df)
        contigs = [str(x) for x in df["contig"]]
        r_start = df["start"]
        r_stop = df["stop"]
        r_total = df["totalCount"]
        r_gwph = df["blockGWPhase"]
        r_gwstat = df["gwStat"]
        r_vars = [str(x) for x in df["variants"]]
        r_acount = df["aCount"]
        r_bcount = df["bCount"]
        r_areads = ([str(x) for x in df["aReads"]]
                    if "aReads" in df else None)
        r_breads = ([str(x) for x in df["bReads"]]
                    if "bReads" in df else None)
        r_maf = df["max_haplo_maf"] if has_maf_col else None

        # one batched interval stab per contig instead of a per-row query
        row_hits: List[Optional[np.ndarray]] = [None] * n_rows
        rows_by_contig: Dict[str, List[int]] = defaultdict(list)
        for ri in range(n_rows):
            if r_total[ri] > 0 and contigs[ri] in index:
                rows_by_contig[contigs[ri]].append(ri)
        for chrom, rids in rows_by_contig.items():
            ix = index[chrom]
            qbeg = np.asarray([r_start[ri] for ri in rids], np.int64) - 1
            qend = np.asarray([r_stop[ri] for ri in rids], np.int64)
            his = np.searchsorted(ix.starts, qend, side="left")
            los = np.searchsorted(ix.cummax_end, qbeg, side="right")
            for k, ri in enumerate(rids):
                lo, hi = int(los[k]), int(his[k])
                if lo >= hi:
                    continue
                mask = ix.ends[lo:hi] > qbeg[k]
                if mask.any():
                    row_hits[ri] = ix.ids[lo:hi][mask]

        for ri in range(n_rows):
            hits = row_hits[ri]
            if hits is None:
                continue
            xvars = r_vars[ri].split(",")
            if id_separator not in xvars[0] or xvars[0].count(id_separator) < 3:
                raise ValueError("ID separator not found in variant ID")
            # 0-based variant positions + first-occurrence index per id
            # (reference uses xvars.index(xvar): first occurrence wins)
            xpos = np.asarray(
                [int(x.split(id_separator)[1]) - 1 for x in xvars], np.int64)
            first_idx: Dict[str, int] = {}
            for i, x in enumerate(xvars):
                if x not in first_idx:
                    first_idx[x] = i
            mapped_cache: Dict[bytes, dict] = {}
            gwph = r_gwph[ri]
            is_gw_row = gwph != "0/1" and float(r_gwstat[ri] >= gw_cutoff)
            for fid in hits:
                f = feats[int(fid)]
                selmask = (xpos >= f.start) & (xpos <= f.stop)
                ck = selmask.tobytes()
                mapped = mapped_cache.get(ck)
                if mapped is None:
                    mapped = _mapped_counts(
                        xvars, selmask, first_idx, int(r_acount[ri]),
                        int(r_bcount[ri]),
                        r_areads[ri] if r_areads is not None else "",
                        r_breads[ri] if r_breads is not None else "")
                    mapped_cache[ck] = mapped
                st = state[int(fid)]
                if is_gw_row:
                    if min_haplo_maf > 0 and has_maf_col and \
                            r_maf[ri] < min_haplo_maf:
                        if mapped["totalCount"] > (st["unphased_aCount"] +
                                                   st["unphased_bCount"]):
                            st["unphased_aCount"] = mapped["aCount"]
                            st["unphased_bCount"] = mapped["bCount"]
                            st["unphased_variants"] = mapped["variants"]
                        maf_filtered += 1
                        continue
                    if gwph == "0|1":
                        st["aCount"] += mapped["aCount"]
                        st["bCount"] += mapped["bCount"]
                    elif gwph == "1|0":
                        st["aCount"] += mapped["bCount"]
                        st["bCount"] += mapped["aCount"]
                    st["variants"] += mapped["variants"]
                else:
                    if mapped["totalCount"] > (st["unphased_aCount"] +
                                               st["unphased_bCount"]):
                        st["unphased_aCount"] = mapped["aCount"]
                        st["unphased_bCount"] = mapped["bCount"]
                        st["unphased_variants"] = mapped["variants"]

        if maf_filtered > 0:
            log("          %d of %d haplotypes treated as unphased due to "
                "low MAF" % (maf_filtered, len(df)))

        for i in range(len(feats)):
            st = state[i]
            f = feats[i]
            phased_tot = st["aCount"] + st["bCount"]
            unphased_tot = st["unphased_aCount"] + st["unphased_bCount"]
            if phased_tot >= unphased_tot:
                total_cov = phased_tot
                log2_afc = zero_log(zero_divide(st["aCount"], st["bCount"]), 2)
                if total_cov >= min_cov:
                    out.write("\t".join(map(str, [
                        f.chrom, f.start, f.stop, f.name, st["aCount"],
                        st["bCount"], total_cov, log2_afc,
                        len(st["variants"]), ",".join(st["variants"]), 1,
                        xbam])) + "\n")
            elif phased_tot < unphased_tot:
                total_cov = unphased_tot
                log2_afc = zero_log(zero_divide(st["unphased_aCount"],
                                                st["unphased_bCount"]), 2)
                if total_cov >= min_cov:
                    out.write("\t".join(map(str, [
                        f.chrom, f.start, f.stop, f.name,
                        st["unphased_aCount"], st["unphased_bCount"],
                        total_cov, log2_afc, len(st["unphased_variants"]),
                        ",".join(st["unphased_variants"]), 0, xbam])) + "\n")
    out.close()


def _mapped_counts(xvars: List[str], selmask: np.ndarray,
                   first_idx: Dict[str, int], a_count: int, b_count: int,
                   a_reads: str, b_reads: str) -> dict:
    """variant_feature_reads (phaser_gene_ae.py:172-219): unique-read
    counting over the variants inside the feature (inclusive-end quirk and
    the xvars.index first-occurrence behavior preserved). Pure function of
    (row, selected-variant mask) so callers memoize it across features."""
    sel = np.flatnonzero(selmask)
    used_vars = [xvars[i] for i in sel]
    if not used_vars:
        return {"variants": used_vars, "aCount": 0, "bCount": 0,
                "totalCount": 0}
    if len(xvars) == 1:
        # single-variant block: the reference synthesizes range(aCount)
        # fake read ids — their set sizes are exactly the counts
        return {"variants": used_vars, "aCount": a_count, "bCount": b_count,
                "totalCount": a_count + b_count}
    a_segs = a_reads.split(";")
    b_segs = b_reads.split(";")
    sa: set = set()
    sb: set = set()
    for x in used_vars:
        i = first_idx[x]
        sa.update(a_segs[i].split(","))
        sb.update(b_segs[i].split(","))
    sa.discard("")
    sb.discard("")
    return {"variants": used_vars, "aCount": len(sa), "bCount": len(sb),
            "totalCount": len(sa) + len(sb)}
