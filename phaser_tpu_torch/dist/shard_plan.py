"""Weight-balanced position-range shard planning for the full engine.

The reference caps engine parallelism at one worker per contig
(reference phaser/phaser.py:62 "1 thread per contig for haplotype
construction") and its fork pool inherits whatever skew the contig sizes
carry (human chr1 holds ~8x chr21's reads).  phaser_tpu shards by
(contig, position-range) instead, sized by the COMPRESSED BYTE SPAN each
range occupies in the BAM (taken from the BAI linear index — decode is the
dominant cost, so bytes are the honest weight), so:

  * n_shards can exceed n_contigs (big contigs split at 16 KiB window
    granularity), and
  * skewed contigs no longer cap scaling.

Correctness model (no halo needed):

  * a read belongs to exactly ONE range — the one containing its START
    (reads are coordinate-sorted, so ranges decode contiguous file spans);
  * every decoding shard classifies its reads against the FULL per-contig
    variant table, so a read spanning a range/shard boundary still yields
    every one of its hits, exactly once;
  * all rows of a contig are then exchanged to the contig's OWNER shard,
    which runs the graph stages (connections / blocks / phasing) on
    complete per-contig data — connections never cross contigs
    (phaser.py:1278-1280), so ownership at contig granularity is exact.

Ownership = the shard that decodes the contig's first range; ranges are
assigned to shards contiguously in (contig, position) order, so owners are
non-decreasing in global contig order — the per-shard output files
concatenate into the single-process byte order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WIN = 1 << 14  # BAI linear window


@dataclass
class ShardPlan:
    """One shard's work assignment."""

    # contig -> ordered [(lo, hi)) position ranges this shard DECODES
    decode: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    # contig -> global range rank of each decode range (row_seq entry keys)
    range_rank: Dict[str, List[int]] = field(default_factory=dict)
    # contigs this shard OWNS (graph stages + outputs), in global order
    own: List[str] = field(default_factory=list)

    def touched_contigs(self, order: Sequence[str]) -> List[str]:
        t = set(self.decode) | set(self.own)
        return [c for c in order if c in t]


def _resolve_tid(name_to_tid: Dict[str, int], c: str) -> Optional[int]:
    """BAM tid for VCF contig name `c`, tolerating a chr-prefix mismatch
    in either direction ('chr1' vs '1')."""
    if c in name_to_tid:
        return name_to_tid[c]
    if ("chr" + c) in name_to_tid:
        return name_to_tid["chr" + c]
    if c.startswith("chr") and c[3:] in name_to_tid:
        return name_to_tid[c[3:]]
    return None


def _range_weights(bam_paths: Sequence[str], contigs: Sequence[str]):
    """Per contig: (window byte-weight array, contig_length_windows) summed
    over all BAMs, from each BAM's BAI linear index.  Windows with no index
    delta get weight epsilon so empty stretches merge into neighbours."""
    from ..io.bam_index import BaiIndex, ensure_bai
    from ..io.bam import read_bam

    weights: Dict[str, np.ndarray] = {}
    for bam in bam_paths:
        bai_p = ensure_bai(bam)
        if bai_p is None:
            return None
        bai = BaiIndex.from_path(bai_p)
        from ..io.bam_index import read_bam_header_meta
        ref_names, ref_lengths, _ = read_bam_header_meta(bam)
        name_to_tid = {n: i for i, n in enumerate(ref_names)}
        for c in contigs:
            # same chr-prefix tolerance as the decode path
            # (engine.pipeline._process_planned_bam tries vt.chrom then the
            # bare VCF name): a VCF 'chr1' vs BAM '1' mismatch must not
            # silently zero every weight and serialize the run onto shard 0
            tid = _resolve_tid(name_to_tid, c)
            if tid is None:
                continue
            lin = bai.linear[tid].astype(np.int64)
            if bai.min_shift != 14:
                # foreign CSI granularity: resample the window table to
                # the planner's 16 KiB atoms (our own indexer always
                # writes min_shift=14, so this is an interop path only)
                f = 2 ** abs(bai.min_shift - 14)
                if bai.min_shift > 14:
                    lin = np.repeat(lin, f)
                else:
                    pad = (-len(lin)) % f
                    lp = np.pad(lin, (0, pad))
                    lp = lp.reshape(-1, f)
                    m = np.where(lp > 0, lp, np.iinfo(np.int64).max)
                    lin = m.min(axis=1)
                    lin[lin == np.iinfo(np.int64).max] = 0
            n_win = max(len(lin), 1)
            w = np.zeros(n_win, np.float64)
            if len(lin):
                coff = lin >> 16
                # forward-fill zeros (never-set leading windows)
                nz = coff > 0
                if nz.any():
                    first = int(np.argmax(nz))
                    coff[:first] = coff[nz][0]
                    # byte span per window = delta to next window's offset
                    d = np.diff(coff.astype(np.float64))
                    w[:-1] += np.maximum(d, 0.0)
                    w[-1] += 1.0  # tail window: unknown span, nominal
            prev = weights.get(c)
            if prev is None:
                weights[c] = w
            else:
                m = max(len(prev), len(w))
                out = np.zeros(m, np.float64)
                out[:len(prev)] += prev
                out[:len(w)] += w
                weights[c] = out
    return weights


def plan_shards(bam: str, contigs: Sequence[str], n_shards: int,
                contig_lengths: Optional[Dict[str, int]] = None
                ) -> List[ShardPlan]:
    """Deterministic plan: split the (contig, window) weight sequence into
    n_shards contiguous spans of ~equal byte weight; a contig is split at
    16 KiB window boundaries when a shard boundary falls inside it.

    Every process/thread computes the identical plan from the BAM's BAI
    (built if missing).  Falls back to whole-contig count-balanced shards
    when no index can be built (plan still valid; ranges = whole contig).
    """
    bams = [b for b in bam.split(",") if b]
    weights = _range_weights(bams, contigs)
    if weights is not None and \
            sum(float(w.sum()) for w in weights.values()) <= 0.0:
        # no contig resolved to any indexed reads (e.g. an unresolvable
        # name mismatch): a zero-weight walk would put every atom on
        # shard 0 — fall back to count-balanced whole contigs instead
        weights = None
    plans = [ShardPlan() for _ in range(n_shards)]
    big = 1 << 62

    if weights is None:
        # fallback: count-balanced whole contigs (the round-3 behavior)
        base, rem = divmod(len(contigs), n_shards)
        i = 0
        rank = 0
        for s in range(n_shards):
            k = base + (1 if s < rem else 0)
            for c in contigs[i:i + k]:
                plans[s].decode[c] = [(0, big)]
                plans[s].range_rank[c] = [rank]
                plans[s].own.append(c)
                rank += 1
            i += k
        return plans

    # flatten to (contig, win_lo, win_hi, weight) atoms; merge zero-weight
    # windows into their successor so atoms stay meaningful
    atoms: List[Tuple[str, int, int, float]] = []
    for c in contigs:
        w = weights.get(c)
        if w is None or len(w) == 0:
            atoms.append((c, 0, big, 0.0))
            continue
        for i, wt in enumerate(w.tolist()):
            lo = i * _WIN
            hi = (i + 1) * _WIN if i + 1 < len(w) else big
            atoms.append((c, lo, hi, wt))
    total = sum(a[3] for a in atoms) or 1.0
    target = total / n_shards

    # contiguous assignment: walk atoms, cut when a shard reaches target
    s = 0
    acc = 0.0
    assign: List[int] = []
    for c, lo, hi, wt in atoms:
        if s < n_shards - 1 and acc >= target and acc > 0:
            s += 1
            acc = 0.0
        assign.append(s)
        acc += wt
    # coalesce per (shard, contig) into ranges; assign global range ranks
    rank_of: Dict[str, int] = {}
    for (c, lo, hi, wt), sid in zip(atoms, assign):
        p = plans[sid]
        ranges = p.decode.setdefault(c, [])
        ranks = p.range_rank.setdefault(c, [])
        if ranges and ranges[-1][1] == lo:
            ranges[-1] = (ranges[-1][0], hi)
        else:
            r = rank_of.get(c, 0)
            ranges.append((lo, hi))
            ranks.append(r)
            rank_of[c] = r + 1
    # ownership: the shard decoding the contig's first range. Walking
    # contigs in global order keeps owners non-decreasing (atoms were
    # assigned contiguously), so per-shard outputs concatenate into the
    # single-process byte order; a contig absent from every BAM goes to
    # the previous contig's owner (still non-decreasing).
    prev_owner = 0
    for c in contigs:
        owner = None
        for sid in range(n_shards):
            if c in plans[sid].range_rank and 0 in plans[sid].range_rank[c]:
                owner = sid
                break
        if owner is None:
            owner = prev_owner
        plans[owner].own.append(c)
        prev_owner = owner
    return plans
