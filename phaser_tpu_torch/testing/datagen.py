"""Synthetic BAM/VCF fixture generator for parity and kernel tests.

Generates a diploid genome with phased het sites, then RNA-seq-like reads
(paired, spliced, soft-clipped, with indel errors and quality noise) from the
two haplotypes.  Emits:
  - bgzipped + tabix-indexed VCF (via phaser_tpu's own codecs)
  - coordinate-sorted BAM
  - SAM text (to drive the reference mapper for byte-parity tests)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import bam as bamio
from ..io import bgzf, tabix

BASES = "ACGT"


@dataclasses.dataclass
class SynthVariant:
    chrom: str
    pos: int              # 1-based
    rsid: str
    ref: str
    alts: List[str]
    gt: str               # e.g. "0|1", "1/0"
    af: float
    filt: str = "PASS"


@dataclasses.dataclass
class SynthData:
    contigs: List[str]
    contig_lens: Dict[str, int]
    genome: Dict[str, str]
    variants: List[SynthVariant]
    sam_lines: List[str]           # body only (no header)
    sam_header: List[str]
    bam_records: List[bamio.BamRecord]
    sample: str = "SAMPLE1"

    def write_vcf(self, path_gz: str, extra_samples: int = 0,
                  extra_format: bool = False) -> None:
        """extra_format adds DP/GQ FORMAT fields (some rows intentionally
        truncated, exercising the writer's missing-column padding)."""
        lines = [
            "##fileformat=VCFv4.2",
            '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        ]
        if extra_format:
            lines.append('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">')
            lines.append('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="GQ">')
        for c in self.contigs:
            lines.append("##contig=<ID=%s,length=%d>" % (c, self.contig_lens[c]))
        samples = [self.sample] + ["OTHER%d" % i for i in range(extra_samples)]
        lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
                     "\t".join(samples))
        rng = np.random.default_rng(7)
        for vi, v in enumerate(self.variants):
            af = ",".join("%g" % a for a in np.atleast_1d(v.af))
            if extra_format:
                fmt = "GT:DP:GQ"
                gt_cell = v.gt + ":%d:%d" % (rng.integers(5, 90),
                                             rng.integers(10, 99))
                if vi % 7 == 0:
                    gt_cell = v.gt  # truncated sample column
                elif vi % 11 == 0:
                    gt_cell = v.gt + ":%d" % rng.integers(5, 90)
            else:
                fmt = "GT"
                gt_cell = v.gt
            row = [v.chrom, str(v.pos), v.rsid, v.ref, ",".join(v.alts), "100",
                   v.filt, "AF=%s" % af, fmt, gt_cell]
            for _ in range(extra_samples):
                ogt = rng.choice(["0|0", "0|1", "1|1", "1|0"])
                if extra_format:
                    ogt = ogt + ":%d:%d" % (rng.integers(5, 90),
                                            rng.integers(10, 99))
                row.append(ogt)
            lines.append("\t".join(row))
        text = ("\n".join(lines) + "\n").encode()
        bgzf.compress_to_path(text, path_gz)
        tabix.build_vcf_index(path_gz)

    def write_bam(self, path: str) -> None:
        bamio.write_bam(path, self.contigs,
                        [self.contig_lens[c] for c in self.contigs],
                        self.bam_records)

    def sam_text(self) -> str:
        return "\n".join(self.sam_header + self.sam_lines) + "\n"


def _mutate(seq: str, pos0: int, ref: str, alt: str) -> str:
    return seq[:pos0] + alt + seq[pos0 + len(ref):]


def generate(seed: int = 0,
             contigs: Tuple[str, ...] = ("chr20", "chr21"),
             contig_len: int = 60000,
             n_variants_per_contig: int = 120,
             n_reads_per_contig: int = 1500,
             read_len: int = 76,
             paired: bool = True,
             frac_spliced: float = 0.15,
             frac_indel_reads: float = 0.08,
             frac_softclip: float = 0.1,
             error_rate: float = 0.002,
             frac_unphased_gt: float = 0.1,
             frac_multiallelic: float = 0.05,
             frac_nonpass: float = 0.05,
             include_indel_variants: bool = False,
             sample: str = "SAMPLE1",
             read_seed: Optional[int] = None) -> SynthData:
    rng = np.random.default_rng(seed)
    genome: Dict[str, str] = {}
    variants: List[SynthVariant] = []
    hap_seqs: Dict[str, Tuple[str, str]] = {}

    # scalar or per-contig sequence (skewed fixtures: one contig can carry
    # most of the reads/variants to exercise weight-balanced sharding)
    def _per(v, ci):
        return int(v[ci]) if isinstance(v, (list, tuple)) else int(v)

    for ci, chrom in enumerate(contigs):
        clen = _per(contig_len, ci)
        nvar = _per(n_variants_per_contig, ci)
        g = "".join(rng.choice(list(BASES), size=clen))
        genome[chrom] = g
        pos_pool = rng.choice(np.arange(200, clen - 200), size=nvar * 3,
                              replace=False)
        pos_pool = np.sort(pos_pool)
        # enforce min spacing 4 to keep ref spans disjoint
        keep = [int(pos_pool[0])]
        for p in pos_pool[1:]:
            if p - keep[-1] >= 5:
                keep.append(int(p))
            if len(keep) >= nvar:
                break
        hap0b = bytearray(g, "ascii")   # in-place SNP mutation (O(1) each)
        hap1b = bytearray(g, "ascii")
        hap_changed = [False, False]
        for vi, pos0 in enumerate(keep):
            ref = g[pos0]
            if include_indel_variants and rng.random() < 0.1:
                if rng.random() < 0.5:
                    ref = g[pos0:pos0 + 3]  # deletion
                    alts = [ref[0]]
                else:
                    alts = [ref + "".join(rng.choice(list(BASES), size=2))]  # insertion
            elif rng.random() < frac_multiallelic:
                others = [b for b in BASES if b != ref]
                alts = list(rng.choice(others, size=2, replace=False))
            else:
                alts = [str(rng.choice([b for b in BASES if b != ref]))]
            phased = rng.random() >= frac_unphased_gt
            order = rng.random() < 0.5
            # restrict genotypes to {0, 1} alleles (alt index 1); occasionally 1/2
            if len(alts) == 2 and rng.random() < 0.3:
                a, b = "1", "2"
            else:
                a, b = "0", "1"
            gt = (a + "|" + b) if order else (b + "|" + a)
            if not phased:
                gt = gt.replace("|", "/")
            filt = "PASS" if rng.random() >= frac_nonpass else "q10"
            af = float(np.round(rng.uniform(0.01, 0.99), 4))
            v = SynthVariant(chrom, pos0 + 1, "rs%d_%d" % (ci, vi), ref, alts, gt,
                             af, filt)
            variants.append(v)
            # apply to haplotypes (use gt allele indices; unphased applied as listed)
            galleles = gt.replace("/", "|").split("|")
            all_alleles = [v.ref] + v.alts
            ha = all_alleles[int(galleles[0])]
            hb = all_alleles[int(galleles[1])]
            if len(ha) == len(v.ref):
                hap0b[pos0:pos0 + len(v.ref)] = ha.encode()
            if len(hb) == len(v.ref):
                hap1b[pos0:pos0 + len(v.ref)] = hb.encode()
        hap_seqs[chrom] = (hap0b.decode(), hap1b.decode())

    sam_header = ["@HD\tVN:1.6\tSO:coordinate"]
    for c in contigs:
        sam_header.append("@SQ\tSN:%s\tLN:%d"
                          % (c, _per(contig_len, contigs.index(c))))

    # ------------------------------------------------------------------
    # reads (separate stream when read_seed given: same genome/variants,
    # different reads -- for multi-BAM fixtures)
    # ------------------------------------------------------------------
    if read_seed is not None:
        rng = np.random.default_rng(read_seed)
    recs: List[Tuple[int, bamio.BamRecord]] = []  # (sortkey, record)
    read_id = 0
    for ci, chrom in enumerate(contigs):
        for _ in range(_per(n_reads_per_contig, ci)):
            hap = int(rng.integers(0, 2))
            src = hap_seqs[chrom][hap]
            start0 = int(rng.integers(0, _per(contig_len, ci) - 1200))
            name = "read_%s_%d" % (chrom, read_id)
            read_id += 1
            mapq = int(rng.choice([60, 60, 60, 255, 30, 10]))
            as_score = int(rng.integers(100, 160))
            isize = int(rng.integers(150, 600))

            def make_read(s0: int) -> Optional[Tuple[int, str, List[Tuple[int, int]], str]]:
                """Return (pos0, seq, cigar, None) simulating one mate."""
                cig: List[Tuple[int, int]] = []
                seq_parts: List[str] = []
                gpos = s0
                remaining = read_len
                # soft clip head
                if rng.random() < frac_softclip / 2:
                    sc = int(rng.integers(2, 8))
                    cig.append((sc, bamio.OP_S))
                    seq_parts.append("".join(rng.choice(list(BASES), size=sc)))
                    remaining -= sc
                spliced = rng.random() < frac_spliced
                seg1 = remaining if not spliced else int(rng.integers(20, remaining - 10))
                seq_parts.append(src[gpos:gpos + seg1])
                cig.append((seg1, bamio.OP_M))
                gpos += seg1
                remaining -= seg1
                if spliced and remaining > 0:
                    gap = int(rng.integers(50, 500))
                    cig.append((gap, bamio.OP_N))
                    gpos += gap
                    seq_parts.append(src[gpos:gpos + remaining])
                    cig.append((remaining, bamio.OP_M))
                    gpos += remaining
                    remaining = 0
                elif remaining > 0:
                    seq_parts.append(src[gpos:gpos + remaining])
                    cig.append((remaining, bamio.OP_M))
                    gpos += remaining
                    remaining = 0
                seq = "".join(seq_parts)
                # read-level indels (errors)
                if rng.random() < frac_indel_reads and len(cig) == 1:
                    # convert to M I M or M D M
                    third = len(seq) // 3
                    if rng.random() < 0.5:
                        ins = "".join(rng.choice(list(BASES), size=2))
                        seq = seq[:third] + ins + seq[third:]
                        cig = [(third, bamio.OP_M), (2, bamio.OP_I),
                               (len(seq) - third - 2, bamio.OP_M)]
                    else:
                        dl = 2
                        cig = [(third, bamio.OP_M), (dl, bamio.OP_D),
                               (len(seq) - third, bamio.OP_M)]
                        # deleted genome bases not in read; extend tail from genome
                return s0, seq, cig, None

            m1 = make_read(start0)
            if m1 is None:
                continue
            pos1, seq1, cig1, _ = m1
            # substitution errors + quals
            def finish(seq: str) -> Tuple[str, List[int]]:
                n_b = len(seq)
                quals = rng.choice([38, 38, 38, 30, 20, 8], size=n_b)
                err = rng.random(n_b) < error_rate
                if err.any():
                    s = np.frombuffer(seq.encode(), np.uint8).copy()
                    # substitute with the "next" base cyclically + random skip
                    shift = rng.integers(1, 4, size=int(err.sum()))
                    base_arr = np.frombuffer(b"ACGT", np.uint8)
                    cur = s[err]
                    cur_idx = np.searchsorted(base_arr, cur)
                    cur_idx[cur_idx > 3] = 0
                    s[err] = base_arr[(cur_idx + shift) % 4]
                    seq = s.tobytes().decode()
                return seq, [int(q) for q in quals]

            seq1, q1 = finish(seq1)
            flag1 = 0
            is_dup = rng.random() < 0.03
            if is_dup:
                flag1 |= bamio.FLAG_DUP
            if paired:
                mate_start0 = pos1 + isize - read_len
                m2 = make_read(mate_start0)
                pos2, seq2, cig2, _ = m2
                seq2, q2 = finish(seq2)
                proper = rng.random() < 0.92
                f1 = flag1 | bamio.FLAG_PAIRED | (bamio.FLAG_PROPER_PAIR if proper else 0) | 0x40
                f2 = flag1 | bamio.FLAG_PAIRED | (bamio.FLAG_PROPER_PAIR if proper else 0) | 0x80 | bamio.FLAG_REVERSE
                tl = (pos2 + read_len) - pos1
                recs.append((pos1, bamio.BamRecord(
                    name, ci, pos1, mapq, f1, cig1, seq1, q1, ci, pos2, tl,
                    tags=[("NH", "i", 1), ("AS", "i", as_score)])))
                recs.append((pos2, bamio.BamRecord(
                    name, ci, pos2, mapq, f2, cig2, seq2, q2, ci, pos1, -tl,
                    tags=[("NH", "i", 1), ("AS", "i", as_score)])))
            else:
                recs.append((pos1, bamio.BamRecord(
                    name, ci, pos1, mapq, flag1, cig1, seq1, q1, -1, -1, 0,
                    tags=[("AS", "i", as_score)])))

    recs.sort(key=lambda t: (t[1].refid, t[0]))
    bam_records = [r for _, r in recs]

    # SAM text mirrors the BAM exactly
    sam_lines = []
    for r in bam_records:
        cigs = "".join("%d%s" % (ln, bamio.CIGAR_OPS[op]) for ln, op in r.cigar)
        tag_strs = []
        for tag, typ, val in r.tags:
            t = "i" if typ in "cCsSiI" else typ
            tag_strs.append("%s:%s:%s" % (tag, t, val))
        sam_lines.append("\t".join([
            r.name, str(r.flag), contigs[r.refid], str(r.pos + 1), str(r.mapq),
            cigs, "=" if r.next_refid == r.refid else "*",
            str(r.next_pos + 1), str(r.tlen),
            r.seq, "".join(chr(q + 33) for q in r.qual)] + tag_strs))

    return SynthData(list(contigs),
                     {c: _per(contig_len, i) for i, c in enumerate(contigs)},
                     genome,
                     variants, sam_lines, sam_header, bam_records, sample)


def write_fixture_dir(tmpdir: str, **kw) -> Tuple[str, str, SynthData]:
    data = generate(**kw)
    vcf_path = os.path.join(tmpdir, "sample.vcf.gz")
    bam_path = os.path.join(tmpdir, "sample.bam")
    data.write_vcf(vcf_path)
    data.write_bam(bam_path)
    return vcf_path, bam_path, data
