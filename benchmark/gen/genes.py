"""Genes of an RNA-seq traffic mix: their exon-intron structure, their
share of the fragments and their allelic ratio.

The set of genes is the same for every seed: it is drawn once from the
mix's `shape_seed`, with expression shares at fixed quantiles of a
log-normal (capped, as no gene of a tissue takes more than a few percent
of the reads) and one gene in `imbalanced_every` given a ratio away from
1:1.  The run's seed only lays them out along the region, in another
order and with other gaps, so that each seed asks for the same work."""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Genes:
    exon_start: np.ndarray    # int64 0-based genomic starts, all exons
    exon_len: np.ndarray      # int64
    gene_of_exon: np.ndarray  # int64
    first_exon: np.ndarray    # per gene: index of its first exon; +1 entry
    tx_len: np.ndarray        # per gene: transcript length
    share: np.ndarray         # per gene: share of the fragments
    ratio: np.ndarray         # per gene: probability a fragment is hap 1


def _capped_shares(n: int, sigma: float, cap: float) -> np.ndarray:
    q = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    w = np.exp(sigma * np.asarray(q))
    w /= w.sum()
    for _ in range(100):
        over = w > cap
        if not over.any() or over.all():
            break
        spare = (w[over] - cap).sum()
        w[over] = cap
        w[~over] += spare * w[~over] / w[~over].sum()
    return w


def gene_shapes(mix: dict):
    """(exon lengths, intron lengths, share, ratio) of each gene, from the
    mix alone."""
    rng = np.random.default_rng(int(mix["shape_seed"]))
    n = int(mix["genes"])
    share = _capped_shares(n, float(mix["expression_sigma"]),
                           float(mix["max_gene_share"]))
    ratios = np.full(n, 0.5)
    k = int(mix["imbalanced_every"])
    lo, hi = mix["imbalanced_ratio"]
    imb = rng.permutation(n)[:n // k]
    side = rng.integers(0, 2, len(imb))
    ratios[imb] = np.where(side == 1, hi, lo) + rng.uniform(
        -0.05, 0.05, len(imb))
    shapes = []
    for g in range(n):
        n_ex = int(min(2 + rng.poisson(mix["exons_mean"] - 2), 40))
        ex = np.clip(rng.lognormal(np.log(mix["exon_median"]), 0.6, n_ex),
                     60, 3000).astype(np.int64)
        ex[-1] = int(np.clip(rng.lognormal(np.log(mix["last_exon_median"]),
                                           0.7), 300, 8000))
        intr = np.clip(rng.lognormal(np.log(mix["intron_median"]),
                                     mix["intron_sigma"], n_ex - 1),
                       80, mix["intron_max"]).astype(np.int64)
        shapes.append((ex, intr))
    return shapes, share, ratios


def lay_out(mix: dict, r0: int, r1: int, rng: np.random.Generator) -> Genes:
    """The mix's genes laid out along [r0, r1) without overlap, in an order
    and with gaps drawn from `rng`."""
    shapes, share, ratio = gene_shapes(mix)
    n = len(shapes)
    order = rng.permutation(n)
    spans = np.array([s[0].sum() + s[1].sum() for s in shapes], np.int64)
    free = (r1 - r0) - 4000 - int(spans.sum())
    if free <= 0:
        raise ValueError("the mix's genes do not fit in the region")
    cuts = np.sort(rng.integers(0, free, n))
    gaps = np.diff(np.concatenate(([0], cuts)))
    starts, ex_s, ex_l, ex_g = {}, [], [], []
    at = r0 + 2000
    for i, g in enumerate(order):
        at += int(gaps[i])
        starts[g] = at
        at += int(spans[g])
    first = np.zeros(n + 1, np.int64)
    for g in range(n):
        ex, intr = shapes[g]
        gs = starts[g] + np.concatenate(([0], np.cumsum(ex[:-1] + intr)))
        ex_s.append(gs)
        ex_l.append(ex)
        ex_g.append(np.full(len(ex), g))
        first[g + 1] = first[g] + len(ex)
    exon_len = np.concatenate(ex_l)
    tx = np.add.reduceat(exon_len, first[:-1])
    return Genes(np.concatenate(ex_s), exon_len, np.concatenate(ex_g),
                 first, tx, share, ratio)


def tx_to_genome(genes: Genes, g: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Genomic 0-based position of transcript offset t of gene g."""
    cum = np.concatenate(([0], np.cumsum(genes.exon_len)))
    # offset of each gene's transcript start in the flat exon sequence
    flat = cum[genes.first_exon[g]] + t
    e = np.searchsorted(cum, flat, side="right") - 1
    return genes.exon_start[e] + (flat - cum[e])
