"""The examples/full_workflow.py chain through the port on the CPU: the
engine (device="cpu") -> gene_ae -> expr_matrix -> cis_var (engine="torch",
device="cpu") -> annotate, against the same chain through phaser_tpu
(engine device="host", cis_var's numpy engine), on the same input files.
Every file is byte-equal except cis_var's CI columns (the four bound pairs
and var_het_pval), whose deterministic columns are equal instead."""

import os

import numpy as np
import pytest

import datagen
from phaser_tpu.analysis import annotate as jax_annotate
from phaser_tpu.analysis import cis_var as jax_cis_var
from phaser_tpu.analysis import expr_matrix as jax_expr_matrix
from phaser_tpu.analysis import gene_ae as jax_gene_ae
from phaser_tpu.engine import output_stage as jax_output_stage
from phaser_tpu.engine import pipeline as jax_pipeline
from phaser_tpu_torch.analysis import annotate, cis_var, expr_matrix, gene_ae
from phaser_tpu_torch.engine import output_stage, pipeline
from phaser_tpu_torch.io import bgzf, tabix
from phaser_tpu_torch.testing import popdata

N_SAMPLES = 3
ENGINE_SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
                   ".allele_config.txt", ".haplotypes.txt",
                   ".haplotypic_counts.txt", ".vcf.gz")
DET = ["gene", "var_id", "var_chr", "var_pos", "var_het_n", "var_hom_n",
       "het_hom_pvalue", "var_het_afc", "var_het_abs_afc", "var_hom_afc",
       "var_hom_abs_afc", "var_het_afcs", "var_hom_afcs",
       "var_het_ref_counts", "var_het_alt_counts", "var_hom_hap1_counts",
       "var_hom_hap2_counts", "var_het_sample_ids", "var_hom_sample_ids"]

PACKAGES = {
    "jax": dict(pipeline=jax_pipeline, opts=jax_output_stage.PhaserOptions,
                gene_ae=jax_gene_ae, expr_matrix=jax_expr_matrix,
                cis_var=jax_cis_var, annotate=jax_annotate,
                device="host", cis_kw=dict(engine="numpy")),
    "port": dict(pipeline=pipeline, opts=output_stage.PhaserOptions,
                 gene_ae=gene_ae, expr_matrix=expr_matrix, cis_var=cis_var,
                 annotate=annotate, device="cpu",
                 cis_kw=dict(engine="torch", device="cpu")),
}


def _quiet(*a, **k):
    pass


def _inputs(d):
    """full_workflow.py's inputs: N_SAMPLES phased-sample fixtures, a gene
    BED, a population VCF with pairs and a sample map, and a CADD table."""
    rng = np.random.default_rng(0)
    features = os.path.join(d, "genes.bed")
    genes = []
    with open(features, "w") as f:
        for g in range(12):
            start = 1000 + g * 2300
            genes.append(("ENSG%08d" % g, start))
            f.write("chr22\t%d\t%d\tENSG%08d\n" % (start, start + 2000, g))
    samples = []
    for i in range(N_SAMPLES):
        data = datagen.generate(
            seed=100, read_seed=500 + i, contigs=("chr22",),
            contig_len=30000, n_variants_per_contig=120,
            n_reads_per_contig=2500, sample="SAMPLE%d" % i)
        vcf = os.path.join(d, "s%d.vcf.gz" % i)
        bam = os.path.join(d, "s%d.bam" % i)
        data.write_vcf(vcf)
        data.write_bam(bam)
        samples.append((vcf, bam, data.sample))
    variants = data.variants
    vsamples = ["V%d" % i for i in range(N_SAMPLES)]
    vlines = ["##fileformat=VCFv4.2",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
              "\t".join(vsamples)]
    pairs = ["gene_id\tvar_id\tvar_contig\tvar_pos\tvar_ref\tvar_alt"]
    for k, v in enumerate(variants[:40]):
        if len(v.ref) != 1 or any(len(a) != 1 for a in v.alts):
            continue
        gts = rng.choice(["0|1", "1|0", "0|0", "1|1"], size=N_SAMPLES)
        vlines.append("chr22\t%d\t%s\t%s\t%s\t100\tPASS\t.\tGT\t%s"
                      % (v.pos, v.rsid, v.ref, v.alts[0], "\t".join(gts)))
        pairs.append("%s\t%s\tchr22\t%d\t%s\t%s"
                     % (genes[k % len(genes)][0], v.rsid, v.pos, v.ref,
                        v.alts[0]))
    pop_vcf = os.path.join(d, "pop.vcf.gz")
    bgzf.compress_to_path(("\n".join(vlines) + "\n").encode(), pop_vcf)
    tabix.build_vcf_index(pop_vcf)
    pairs_path = os.path.join(d, "pairs.txt")
    with open(pairs_path, "w") as f:
        f.write("\n".join(pairs) + "\n")
    map_path = os.path.join(d, "sample_map.txt")
    with open(map_path, "w") as f:
        f.write("vcf_sample\tbed_sample\n" + "\n".join(
            "V%d\tS%d" % (i, i) for i in range(N_SAMPLES)) + "\n")
    cadd = popdata.write_cadd(samples[0][0], os.path.join(d, "cadd.tsv.gz"))
    return dict(features=features, samples=samples, pop_vcf=pop_vcf,
                pairs=pairs_path, map=map_path, cadd=cadd)


def _chain(pkg, x, out):
    P = PACKAGES[pkg]
    gdir = os.path.join(out, "gene_ae")
    os.makedirs(gdir)
    for i, (vcf, bam, sample) in enumerate(x["samples"]):
        prefix = os.path.join(out, "s%d" % i)
        P["pipeline"].run_phaser(vcf=vcf, bam=bam, sample=sample, o=prefix,
                                 mapq="10", baseq=10, paired_end="1",
                                 opts=P["opts"](), device=P["device"],
                                 log=_quiet)
        g = os.path.join(gdir, "sample%d.txt" % i)
        P["gene_ae"].run_gene_ae(prefix + ".haplotypic_counts.txt",
                                 x["features"], g, log=_quiet)
        with open(g) as f:
            text = f.read().replace("\ts%d\n" % i, "\tS%d\n" % i)
        with open(g, "w") as f:
            f.write(text)
    P["expr_matrix"].run_expr_matrix(gdir, x["features"],
                                     os.path.join(out, "matrix"), log=_quiet)
    P["cis_var"].run_cis_var(os.path.join(out, "matrix.gw_phased.bed.gz"),
                             x["pop_vcf"], x["pairs"], x["map"],
                             os.path.join(out, "cis_var.txt"), bs=1000,
                             min_cov=2, log=_quiet, **P["cis_kw"])
    P["annotate"].run_annotate(os.path.join(out, "s0.vcf.gz"), "SAMPLE0",
                               os.path.join(out, "compound_hets.txt"),
                               cadd_file=x["cadd"], log=_quiet)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("workflow"))
    x = _inputs(d)
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = os.path.join(d, pkg)
        os.makedirs(outs[pkg])
        _chain(pkg, x, outs[pkg])
    return outs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


FILES = ["s%d%s" % (i, s) for i in range(N_SAMPLES)
         for s in ENGINE_SUFFIXES] + \
    ["gene_ae/sample%d.txt" % i for i in range(N_SAMPLES)] + \
    ["matrix.bed.gz", "matrix.bed.gz.tbi", "matrix.gw_phased.bed.gz",
     "matrix.gw_phased.bed.gz.tbi", "compound_hets.txt"]


@pytest.mark.parametrize("name", FILES)
def test_file_equals_phaser_tpu(chains, name):
    a, b = (os.path.join(chains[p], name) for p in ("jax", "port"))
    if name.endswith(".gz"):
        assert bgzf.read_text_auto(a) == bgzf.read_text_auto(b)
    else:
        assert _read(a) == _read(b)
    assert os.path.getsize(b) > 0


def test_cis_var_det_columns_equal_phaser_tpu(chains):
    def cols(path):
        lines = _read(path).decode().splitlines()
        head = lines[0].split("\t")
        rows = [l.split("\t") for l in lines[1:]]
        return {h: [r[i] for r in rows] for i, h in enumerate(head)}
    A, B = (cols(os.path.join(chains[p], "cis_var.txt"))
            for p in ("jax", "port"))
    assert list(A) == list(B) and len(A["gene"]) > 5
    for c in DET:
        assert A[c] == B[c], c
    assert any(v for v in B["var_het_afc_lower"])
