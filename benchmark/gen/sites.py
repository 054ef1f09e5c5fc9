"""The donor: a reference sequence over the configuration's region, the
donor's non-reference sites on it and its two haplotypes, and the
single-sample VCF that states them.

Every count is fixed by the configuration (lines, het share, indel share),
so two seeds give the same amount of work; the seed moves the sites and
draws the bases, the alleles and each het's phase."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NIB = np.array([1, 2, 4, 8], np.uint8)            # A C G T as BAM nibbles
VCF_BASES = np.array(list("ACGT"))


@dataclass
class Donor:
    contig: str
    r0: int                   # region, 0-based half-open
    r1: int
    genome: np.ndarray        # uint8 nibble codes over [r0, r1)
    haps: np.ndarray          # (2, r1 - r0) uint8: the donor's haplotypes
    pos: np.ndarray           # int64 1-based positions of the VCF lines
    ref: list                 # REF / ALT strings
    alt: list
    gt: np.ndarray            # (n, 2) int8 alleles of haplotypes 0 and 1
    is_snp: np.ndarray        # bool
    vcf_text: str


def _exact(n: int, share: float, rng: np.random.Generator) -> np.ndarray:
    """A mask of exactly round(n * share) of n, at places drawn from rng."""
    m = np.zeros(n, bool)
    m[rng.permutation(n)[:int(round(n * share))]] = True
    return m


def site_offsets(L: int, n: int, genes, r0: int,
                 rng: np.random.Generator):
    """(offsets into the region, exonic mask) of n sites at least 6 apart.
    With genes, each gene's exons hold round(n / L a base) sites and no
    other site falls within 16 bases of an exon, so that every seed puts
    the same number of sites under each gene."""
    margin = 1000
    slots = (L - 2 * margin) // 8
    ex_off = []
    if genes is not None:
        from .genes import tx_to_genome
        for g in range(len(genes.tx_len)):
            k = int(round(genes.tx_len[g] * n / L))
            if k == 0:
                continue
            t = np.sort(rng.choice(int(genes.tx_len[g]) // 8, k,
                                   replace=False)) * 8 + rng.integers(0, 3, k)
            ex_off.append(tx_to_genome(genes, np.full(k, g), t) - r0)
        ex_off = np.concatenate(ex_off) if ex_off else np.zeros(0, np.int64)
        lo = (genes.exon_start - r0 - 16 - margin) // 8
        hi = (genes.exon_start + genes.exon_len - r0 + 16 - margin) // 8 + 1
        diff = np.zeros(slots + 1, np.int64)
        np.add.at(diff, np.clip(lo, 0, slots), 1)
        np.add.at(diff, np.clip(hi, 0, slots), -1)
        free = np.flatnonzero(np.cumsum(diff)[:slots] == 0)
    else:
        ex_off = np.zeros(0, np.int64)
        free = np.arange(slots)
    k_out = n - len(ex_off)
    pick = np.sort(rng.choice(len(free), size=k_out, replace=False))
    out_off = margin + free[pick] * 8 + rng.integers(0, 3, k_out)
    off = np.concatenate([ex_off, out_off])
    exonic = np.concatenate([np.ones(len(ex_off), bool),
                             np.zeros(k_out, bool)])
    order = np.argsort(off, kind="stable")
    return off[order], exonic[order]


def make_donor(cfg: dict, rng: np.random.Generator, genes=None) -> Donor:
    contig = cfg["contig"]
    r0, r1 = cfg["region"][0] - 1, cfg["region"][1]
    vm = cfg["vcf"]
    n = int(vm["lines"])
    L = r1 - r0
    genome = NIB[rng.integers(0, 4, L, dtype=np.uint8)]
    off, exonic = site_offsets(L, n, genes, r0, rng)
    # the shares hold exactly among exonic sites and among the others
    het = np.zeros(n, bool)
    indel = np.zeros(n, bool)
    for part in (exonic, ~exonic):
        idx = np.flatnonzero(part)
        het[idx] = _exact(len(idx), vm["het_share"], rng)
        indel[idx] = _exact(len(idx), vm["indel_share"], rng)
    kind = np.where(indel, rng.integers(1, 3, n), 0)   # 0 SNP, 1 del, 2 ins
    gt = np.ones((n, 2), np.int8)
    flip = rng.integers(0, 2, n).astype(bool)
    gt[het & flip, 0] = 0
    gt[het & ~flip, 1] = 0
    ref_i = np.searchsorted(NIB, genome[off])
    alt_i = (ref_i + rng.integers(1, 4, n)) % 4
    refs = VCF_BASES[ref_i].astype(object)
    alts = VCF_BASES[alt_i].astype(object)
    ilen = rng.integers(1, 5, n)
    for i in np.flatnonzero(kind == 1):
        seg = genome[off[i]:off[i] + ilen[i] + 1]
        alts[i] = refs[i]
        refs[i] = "".join(VCF_BASES[np.searchsorted(NIB, seg)])
    for i in np.flatnonzero(kind == 2):
        alts[i] = refs[i] + "".join(VCF_BASES[rng.integers(0, 4, ilen[i])])
    is_snp = kind == 0
    # the haplotypes carry the SNP alleles; reads show no indel (the run
    # excludes indels, --include_indels 0)
    haps = np.stack([genome, genome])
    alt_code = NIB[alt_i]
    for h in range(2):
        m = is_snp & (gt[:, h] == 1)
        haps[h, off[m]] = alt_code[m]
    pos = r0 + off + 1
    ac = np.where(het, rng.integers(1, 5000, n), rng.integers(2500, 5009, n))
    ids = rng.choice(200_000_000, size=n, replace=False) + 1
    qual = rng.integers(30, 100, n)
    lines = ["##fileformat=VCFv4.2",
             "##FILTER=<ID=PASS,Description=\"All filters passed\">"]
    for name, length in cfg["header_contigs"]:
        lines.append("##contig=<ID=%s,length=%d>" % (name, length))
    lines += ["##INFO=<ID=AC,Number=A,Type=Integer,Description=\"Allele "
              "count\">",
              "##INFO=<ID=AF,Number=A,Type=Float,Description=\"Allele "
              "frequency\">",
              "##FORMAT=<ID=GT,Number=1,Type=String,Description="
              "\"Genotype\">",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + cfg["sample"]]
    body = ["%s\t%d\trs%d\t%s\t%s\t%d\tPASS\tAC=%d;AF=%.4f\tGT\t%d|%d"
            % (contig, p, i, r, a, q, c, c / 5008.0, g0, g1)
            for p, i, r, a, q, c, g0, g1 in zip(
                pos.tolist(), ids.tolist(), refs, alts, qual.tolist(),
                ac.tolist(), gt[:, 0].tolist(), gt[:, 1].tolist())]
    return Donor(contig, r0, r1, genome, haps, pos, list(refs), list(alts),
                 gt, is_snp, "\n".join(lines + body) + "\n")
