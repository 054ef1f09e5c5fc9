"""Synthetic phASER-POP inputs at the shape of the repo's pop benchmark
(bench_pop.py; BASELINE.json config 5, "phaser_pop at GTEx scale"):

  * `make_gene_ae_dir`: S gene-AE sample files of G genes each (the input
    of expr_matrix) and the features BED;
  * `make_hap_counts`: an engine `haplotypic_counts` file of G x 3 blocks
    (the input of gene_ae), with per-variant read-id lists;
  * `make_cis_var_inputs`: an S-sample phased genotype VCF (bgzipped and
    tabix-indexed), P (gene, variant) pairs cycling over the G genes, and
    the vcf_sample -> bed_sample map (the inputs of cis_var with the
    matrix);
  * `write_cadd`: a CADD-shaped annotation file over a VCF's SNVs (the
    input of annotate);
  * `mapper_inputs`: a variant table and SAM text from a BAM and its VCF
    (the inputs of the read -> variant mapper CLI).

Everything is drawn from the numpy Generator it is given; the port's own io
writes the files.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..io import bgzf, tabix

GENE_AE_HEADER = ["contig", "start", "stop", "name", "aCount", "bCount",
                  "totalCount", "log2_aFC", "n_variants", "variants",
                  "gw_phased", "bam"]
HAP_COLUMNS = ["contig", "start", "stop", "variants", "variantCount",
               "variantsBlacklisted", "variantCountBlacklisted",
               "haplotypeA", "haplotypeB", "aCount", "bCount", "totalCount",
               "blockGWPhase", "gwStat", "max_haplo_maf", "bam", "aReads",
               "bReads"]


def gene_layout(n_genes: int) -> Tuple[List[str], np.ndarray]:
    """Gene names and starts: one 1,500 bp gene every 2,000 bp of chr20."""
    return (["ENSG%06d.1" % i for i in range(n_genes)],
            1000 + 2000 * np.arange(n_genes))


def make_gene_ae_dir(tmp: str, rng: np.random.Generator, n_samples: int,
                     n_genes: int) -> Tuple[str, str]:
    """(gene-AE directory, features BED path)."""
    d = os.path.join(tmp, "gene_ae")
    os.makedirs(d, exist_ok=True)
    genes, starts = gene_layout(n_genes)
    features = os.path.join(tmp, "features.bed")
    with open(features, "w") as f:
        f.writelines("chr20\t%d\t%d\t%s\n" % (st, st + 1500, g)
                     for g, st in zip(genes, starts))
    for si in range(n_samples):
        a = rng.integers(0, 40, n_genes)
        b = rng.integers(0, 40, n_genes)
        gw = rng.integers(0, 2, n_genes)
        rows = ["\t".join(GENE_AE_HEADER)]
        rows += ["chr20\t%d\t%d\t%s\t%d\t%d\t%d\t0.0\t2\tv1,v2\t%d\tS%03d"
                 % (starts[gi], starts[gi] + 1500, genes[gi], a[gi], b[gi],
                    a[gi] + b[gi], gw[gi], si) for gi in range(n_genes)]
        with open(os.path.join(d, "sample%03d.txt" % si), "w") as f:
            f.write("\n".join(rows) + "\n")
    return d, features


def make_hap_counts(tmp: str, rng: np.random.Generator, n_genes: int,
                    blocks_per_gene: int = 3, vars_per_block: int = 4,
                    reads_per_var: int = 8) -> str:
    """An engine haplotypic_counts file of n_genes x blocks_per_gene rows;
    returns its path."""
    path = os.path.join(tmp, "hap_counts.txt")
    _, starts = gene_layout(n_genes)
    rid = 0
    lines = ["\t".join(HAP_COLUMNS)]
    for st in starts:
        for _ in range(blocks_per_gene):
            vpos = sorted(rng.integers(st, st + 1500, vars_per_block)
                          .tolist())
            n_a = rng.integers(1, reads_per_var, vars_per_block)
            n_b = rng.integers(1, reads_per_var, vars_per_block)
            a_segs, b_segs = [], []
            for na, nb in zip(n_a, n_b):
                a_segs.append(",".join(map(str, range(rid, rid + na))))
                rid += na
                b_segs.append(",".join(map(str, range(rid, rid + nb))))
                rid += nb
            gwph = "0|1" if rng.integers(0, 2) else "1|0"
            sa, sb = int(n_a.sum()), int(n_b.sum())
            lines.append("\t".join(map(str, [
                "chr20", vpos[0], vpos[-1],
                ",".join("chr20_%d_A_G" % p for p in vpos), len(vpos), "", 0,
                ",".join("A" for _ in vpos), ",".join("G" for _ in vpos),
                sa, sb, sa + sb, gwph, "1.0", "0.3", "pop",
                ";".join(a_segs), ";".join(b_segs)])))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_cis_var_inputs(tmp: str, rng: np.random.Generator, n_samples: int,
                        n_genes: int, n_pairs: int) -> Tuple[str, str, str]:
    """(VCF path, pairs path, sample map path) for n_pairs variants, each
    paired with gene (index % n_genes) so that every pair finds its matrix
    row; sample S%03d of the VCF is column S%03d of the matrix."""
    vs = ["S%03d" % i for i in range(n_samples)]
    map_path = os.path.join(tmp, "sample_map.txt")
    with open(map_path, "w") as f:
        f.write("vcf_sample\tbed_sample\n")
        f.writelines("%s\t%s\n" % (v, v) for v in vs)
    genes, _ = gene_layout(n_genes)
    gt = np.array(["0|0", "0|1", "1|0", "1|1"])
    vcf_rows = ["##fileformat=VCFv4.2",
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
                "\t".join(vs)]
    pair_rows = ["gene_id\tvar_id\tvar_contig\tvar_pos\tvar_ref\tvar_alt"]
    codes = rng.integers(0, 4, size=(n_pairs, n_samples))
    for vi in range(n_pairs):
        pos = 1200 + vi * 2000
        vcf_rows.append("chr20\t%d\tvar%d\tA\tG\t100\tPASS\t.\tGT\t%s"
                        % (pos, vi, "\t".join(gt[codes[vi]])))
        pair_rows.append("%s\tvar%d\tchr20\t%d\tA\tG"
                         % (genes[vi % n_genes], vi, pos))
    vcf_path = os.path.join(tmp, "pop.vcf.gz")
    bgzf.compress_to_path(("\n".join(vcf_rows) + "\n").encode(), vcf_path)
    tabix.build_vcf_index(vcf_path)
    pairs_path = os.path.join(tmp, "pairs.txt")
    with open(pairs_path, "w") as f:
        f.write("\n".join(pair_rows) + "\n")
    return vcf_path, pairs_path, map_path


def head_pairs(pairs_path: str, n: int, out: str) -> str:
    """The first n pairs of a pairs file, with its header, at `out`."""
    with open(pairs_path) as f:
        lines = f.read().splitlines()
    with open(out, "w") as f:
        f.write("\n".join(lines[:n + 1]) + "\n")
    return out


def write_cadd(vcf_path: str, out: str, gene_span: int = 2300,
               n_genes: int = 12) -> str:
    """A bgzipped, tabix-indexed CADD-shaped table (106 columns: position,
    ref, alt, effect, gene id and name, phred last) over the SNVs of a VCF,
    each in gene (pos - 1000) // gene_span when that is below n_genes."""
    rows = []
    for line in bgzf.read_text_auto(vcf_path).decode().splitlines():
        if line.startswith("#"):
            continue
        c = line.split("\t")
        ref, alts = c[3], c[4].split(",")
        if len(ref) != 1 or any(len(a) != 1 for a in alts):
            continue
        cols = ["NA"] * 106
        cols[0], cols[1], cols[2], cols[4] = c[0], c[1], ref, alts[0]
        cols[10] = "NON_SYNONYMOUS"
        gi = (int(c[1]) - 1000) // gene_span
        if 0 <= gi < n_genes:
            cols[92] = "ENSG%08d" % gi
            cols[95] = "GENE%d" % gi
        cols[105] = "10.0"
        rows.append("\t".join(cols))
    bgzf.compress_to_path(("\n".join(rows) + "\n").encode(), out)
    tabix.build_text_index(out, preset="generic", col_seq=1, col_beg=2,
                           col_end=2)
    return out


def mapper_inputs(vcf_path: str, bam_path: str, out_dir: str,
                  max_reads: int) -> Tuple[str, str]:
    """(variant table path, SAM text) for the read -> variant mapper: the
    het sites of the VCF's first sample as the 8-column mapping table, and the
    first max_reads records of the BAM as SAM with its header."""
    from ..engine.varmap import build_variant_table
    from ..io import bam as bamio
    from ..io import vcf as vcfio
    lines = vcfio.het_filtered_lines(vcf_path, 9)
    body = [l for l in lines if not l.startswith("#")]
    hs = vcfio.parse_het_sites(body, "", ["_", ":"], True)
    table = os.path.join(out_dir, "variant_table.tsv")
    with open(table, "w") as f:
        for chrom, recs in hs.pool.items():
            f.write(build_variant_table(chrom, recs).mapping_table_text())
    bd = bamio.read_bam(bam_path)
    sam = ["@HD\tVN:1.6\tSO:coordinate"]
    sam += ["@SQ\tSN:%s\tLN:%d" % (n, l)
            for n, l in zip(bd.ref_names, bd.ref_lengths)]
    sam += [bamio.record_to_sam_line(bd, i)
            for i in range(min(max_reads, len(bd)))]
    return table, "\n".join(sam) + "\n"
