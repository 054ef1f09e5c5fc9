"""The port's downstream tools against phaser_tpu's: gene_ae, expr_matrix,
annotate and the read -> variant mapper CLI, each through both packages'
CLI `main` on the same input files, output files byte-equal (tolerance 0;
the matrices' .bed.gz compared decompressed, their .tbi byte for byte).

Inputs: a datagen fixture phased by phaser_tpu's engine (its
haplotypic_counts feed gene_ae, its phased VCF feeds annotate), small
inputs of the pop benchmark's shape (phaser_tpu_torch.testing.popdata),
and one hand-written case for each pandas behaviour that phaser_tpu's
outputs carry (an empty cell read as NaN, a column of digits read as int,
NaN written as an empty field, an int column with a NaN written as
floats).  The port reads and writes these tables without pandas
(utils/table.py); its reader and writer are also held against pandas
itself on random tables."""

import io
import os

import numpy as np
import pandas as pd
import pytest

import datagen
from phaser_tpu.cli import annotate_main as jax_annotate_main
from phaser_tpu.cli import expr_matrix_main as jax_expr_matrix_main
from phaser_tpu.cli import gene_ae_main as jax_gene_ae_main
from phaser_tpu.cli import mapper_main as jax_mapper_main
from phaser_tpu.engine.output_stage import PhaserOptions
from phaser_tpu.engine.pipeline import run_phaser
from phaser_tpu_torch.cli import annotate_main, expr_matrix_main
from phaser_tpu_torch.cli import gene_ae_main, mapper_main
from phaser_tpu_torch.io import bgzf
from phaser_tpu_torch.testing import popdata
from phaser_tpu_torch.utils import table

GENE_SPAN = 2300


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def phased(tmp_path_factory):
    """phaser_tpu's engine (host) on a datagen fixture: its haplotypic
    counts and phased VCF, and a features BED of 12 genes over it."""
    d = str(tmp_path_factory.mktemp("phased"))
    data = datagen.generate(seed=100, read_seed=500, contigs=("chr22",),
                            contig_len=30000, n_variants_per_contig=120,
                            n_reads_per_contig=2500, sample="SAMPLE0")
    vcf, bam = os.path.join(d, "s.vcf.gz"), os.path.join(d, "s.bam")
    data.write_vcf(vcf)
    data.write_bam(bam)
    prefix = os.path.join(d, "out")
    run_phaser(vcf=vcf, bam=bam, sample=data.sample, o=prefix, mapq="10",
               baseq=10, paired_end="1", opts=PhaserOptions(),
               device="host", log=_quiet)
    features = os.path.join(d, "genes.bed")
    with open(features, "w") as f:
        for g in range(12):
            start = 1000 + g * GENE_SPAN
            f.write("chr22\t%d\t%d\tENSG%08d\n" % (start, start + 2000, g))
    return dict(dir=d, vcf=vcf, bam=bam, prefix=prefix, features=features,
                data=data)


def _both(tmp_path, jax_main, port_main, argv_of, capsys=None):
    """Run both CLIs with argv_of(out_prefix); returns (jax out, port out,
    return codes)."""
    outs, rcs = [], []
    for name, main in (("jax", jax_main), ("port", port_main)):
        o = str(tmp_path / name)
        try:
            rcs.append(main(argv_of(o)))
        except Exception as e:          # the same exception on both sides
            rcs.append(type(e).__name__)
        outs.append(o)
    return outs[0], outs[1], rcs


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# ---- gene_ae -------------------------------------------------------------

HAP_HEADER = "\t".join(popdata.HAP_COLUMNS)


def _hap_row(contig, vpos, a_reads, b_reads, bam="pop", gwph="0|1",
             gwstat="1.0", maf="0.3", counts=None):
    variants = ",".join("%s_%d_A_G" % (contig, p) for p in vpos)
    a_n = len(set(",".join(a_reads).split(",")) - {""})
    b_n = len(set(",".join(b_reads).split(",")) - {""})
    a_n, b_n = counts or (a_n, b_n)
    return "\t".join(map(str, [
        contig, vpos[0], vpos[-1], variants, len(vpos), "", 0,
        ",".join("A" for _ in vpos), ",".join("G" for _ in vpos), a_n, b_n,
        a_n + b_n, gwph, gwstat, maf, bam, ";".join(a_reads),
        ";".join(b_reads)]))


FEATURES_TXT = ("chr20\t1000\t2500\tG1\n01\t1000\t2500\tG2\n"
                "chr20\t3000\t4500\tG3\n")


def _gene_ae_quirk(case):
    """(haplotypic counts text, features text) of one pandas quirk."""
    r1 = _hap_row("chr20", [1100, 1200], ["1,2", "3"], ["4", "5,6"])
    r2 = _hap_row("chr20", [3100], ["7"], ["8,9"])
    if case == "empty_reads":
        # the empty aReads cell is NaN: str() gives "nan", one read id for
        # the first variant of the block, and bReads of a single-variant
        # block is never read
        r1 = _hap_row("chr20", [1100, 2800], [""], ["4", "5,6"],
                      counts=(3, 3))
        r2 = _hap_row("chr20", [3100], ["7"], [""], counts=(1, 2))
        return [HAP_HEADER, r1, r2], FEATURES_TXT
    if case == "numeric_bam":
        return [HAP_HEADER, r1.replace("\tpop\t", "\t01\t"),
                r2.replace("\tpop\t", "\t2\t")], FEATURES_TXT
    if case == "contig_01":
        # contig "01" is read as int 1 and never meets the features' "01"
        return [HAP_HEADER, r1.replace("chr20", "01"), r2], FEATURES_TXT
    if case == "nan_bam":
        return [HAP_HEADER, r1.replace("\tpop\t", "\tNA\t"), r2,
                r2.replace("\tpop\t", "\t\t")], FEATURES_TXT
    if case == "float_bam":
        # digits and empty cells: a float column with a NaN per empty cell
        return [HAP_HEADER, r1.replace("\tpop\t", "\t3\t"),
                r2.replace("\tpop\t", "\t\t"),
                r1.replace("\tpop\t", "\t\t")], FEATURES_TXT
    if case == "low_maf":
        return [HAP_HEADER, r1.replace("\t0.3\t", "\t0.05\t"), r2], \
            FEATURES_TXT
    if case == "multi_reads_missing":
        # aReads empty on a block whose second variant is in a gene: the
        # "nan" cell has one segment, so both packages raise IndexError
        r1 = _hap_row("chr20", [900, 1200], [""], ["4", "5"], counts=(2, 2))
        return [HAP_HEADER, r1], FEATURES_TXT
    raise KeyError(case)


GENE_AE_QUIRKS = ["empty_reads", "numeric_bam", "contig_01", "nan_bam",
                  "float_bam", "low_maf", "multi_reads_missing"]


@pytest.mark.parametrize("case", ["engine", "popdata"] + GENE_AE_QUIRKS)
def test_gene_ae_matches_phaser_tpu(tmp_path, phased, case):
    extra = []
    if case == "engine":
        hap = phased["prefix"] + ".haplotypic_counts.txt"
        features = phased["features"]
    elif case == "popdata":
        rng = np.random.default_rng(3)
        hap = popdata.make_hap_counts(str(tmp_path), rng, 40)
        _, features = popdata.make_gene_ae_dir(str(tmp_path), rng, 1, 40)
    else:
        rows, feat_text = _gene_ae_quirk(case)
        hap = str(tmp_path / "hap.txt")
        with open(hap, "w") as f:
            f.write("\n".join(rows) + "\n")
        features = str(tmp_path / "features.bed")
        with open(features, "w") as f:
            f.write(feat_text)
        if case == "low_maf":
            extra = ["--min_haplo_maf", "0.1"]
    a, b, rcs = _both(tmp_path, jax_gene_ae_main.main, gene_ae_main.main,
                      lambda o: ["--haplotypic_counts", hap, "--features",
                                 features, "--o", o] + extra)
    assert rcs[0] == rcs[1], rcs
    if case == "multi_reads_missing":
        assert rcs == ["IndexError", "IndexError"]
        return
    assert rcs == [0, 0]
    _same_file(a, b)
    text = open(b).read()
    assert text.count("\n") > 1
    if case == "empty_reads":
        assert "\tG1\t1\t1\t2\t" in text        # "nan" is one read id
    if case == "numeric_bam":
        assert text.rstrip().endswith("\t2") and "\t1\n" in text
    if case == "float_bam":
        assert "\t3.0\n" in text and text.count("\tnan\n") == 2 * 3


# ---- expr_matrix ---------------------------------------------------------

def _matrix_outputs(o):
    out = {}
    for sfx in (".bed.gz", ".gw_phased.bed.gz"):
        out[sfx] = bgzf.read_text_auto(o + sfx)
        with open(o + sfx + ".tbi", "rb") as f:
            out[sfx + ".tbi"] = f.read()
    return out


def _expr_quirk(tmp_path, case):
    rng = np.random.default_rng(11)
    d, features = popdata.make_gene_ae_dir(str(tmp_path), rng, 3, 15)
    files = sorted(os.listdir(d))

    def edit(name, fn):
        p = os.path.join(d, name)
        with open(p) as f:
            text = f.read()
        with open(p, "w") as f:
            f.write(fn(text))
    if case == "contig_01":
        for name in files:
            edit(name, lambda t: t.replace("chr20\t", "01\t"))
        with open(features) as f:
            ft = f.read()
        with open(features, "w") as f:
            f.write(ft.replace("chr20\t", "01\t"))
    elif case == "numeric_sample":
        edit(files[0], lambda t: t.replace("\tS000\n", "\t7\n"))
    elif case == "nan_count":
        def blank_acount(t):
            lines = t.split("\n")
            cells = lines[1].split("\t")
            cells[4] = ""
            lines[1] = "\t".join(cells)
            return "\n".join(lines)
        edit(files[1], blank_acount)
    elif case == "dup_sample":
        edit(files[2], lambda t: t.replace("\tS002\n", "\tS000\n"))
    elif case == "features_comment":
        with open(features) as f:
            ft = f.read().splitlines()
        ft[1] = ft[1] + "#a comment after the name"
        with open(features, "w") as f:
            f.write("# a header line\n" + "\n".join(ft) + "\n\n")
    elif case == "wrong_order":
        edit(files[1], lambda t: "\n".join(
            t.split("\n")[:1] + t.split("\n")[2:3] + t.split("\n")[1:2] +
            t.split("\n")[3:]))
    elif case == "gw_nan":
        edit(files[0], lambda t: t.replace("\t1\tS000\n", "\t\tS000\n", 1))
    else:
        raise KeyError(case)
    return d, features


EXPR_QUIRKS = ["contig_01", "numeric_sample", "nan_count", "dup_sample",
               "features_comment", "wrong_order", "gw_nan"]


@pytest.mark.parametrize("case", ["engine", "popdata"] + EXPR_QUIRKS)
def test_expr_matrix_matches_phaser_tpu(tmp_path, phased, case):
    if case == "engine":
        d = str(tmp_path / "gene_ae")
        os.makedirs(d)
        for i in range(3):
            o = os.path.join(d, "s%d.txt" % i)
            assert gene_ae_main.main([
                "--haplotypic_counts",
                phased["prefix"] + ".haplotypic_counts.txt",
                "--features", phased["features"], "--o", o]) == 0
            with open(o) as f:
                text = f.read().replace("\tout\n", "\tS%d\n" % i)
            with open(o, "w") as f:
                f.write(text)
        features = phased["features"]
    elif case == "popdata":
        d, features = popdata.make_gene_ae_dir(str(tmp_path),
                                               np.random.default_rng(5),
                                               12, 60)
    else:
        d, features = _expr_quirk(tmp_path, case)
    a, b, rcs = _both(tmp_path, jax_expr_matrix_main.main,
                      expr_matrix_main.main,
                      lambda o: ["--gene_ae_dir", d, "--features", features,
                                 "--o", o])
    assert rcs[0] == rcs[1], rcs
    if case == "gw_nan":               # int(nan) raises in both
        assert rcs == [1, 1]
        return
    assert rcs == [0, 0]
    ja, pa = _matrix_outputs(a), _matrix_outputs(b)
    for k in ja:
        assert ja[k] == pa[k], k
    body = pa[".bed.gz"].decode()
    if case == "contig_01":
        assert body.split("\n")[1].startswith("1\t")
    if case == "numeric_sample":
        assert body.split("\n")[0].split("\t")[4] == "7"
    if case == "nan_count":
        assert "\tnan|" in body and ".0|" in body
    if case == "dup_sample":
        assert body.split("\n")[0].split("\t")[4:] == ["S000", "S001"]


def test_expr_matrix_reads_back_through_tabix(tmp_path):
    """The port's .bed.gz and .tbi answer region queries through the port's
    TabixFile with the rows of the matrix."""
    from phaser_tpu_torch.io import tabix
    d, features = popdata.make_gene_ae_dir(str(tmp_path),
                                           np.random.default_rng(9), 4, 50)
    o = str(tmp_path / "m")
    assert expr_matrix_main.main(["--gene_ae_dir", d, "--features",
                                  features, "--o", o]) == 0
    rows = bgzf.read_text_auto(o + ".bed.gz").decode().splitlines()[1:]
    tf = tabix.TabixFile(o + ".bed.gz")
    got = list(tf.fetch("chr20", 20000, 40000))
    want = [r for r in rows if int(r.split("\t")[2]) > 20000 and
            int(r.split("\t")[1]) < 40000]
    assert got == want and len(want) > 5


# ---- annotate ------------------------------------------------------------

@pytest.mark.parametrize("case", ["cadd", "cadd_af_vcf", "info_af",
                                  "no_cadd"])
def test_annotate_matches_phaser_tpu(tmp_path, phased, case):
    vcf = phased["prefix"] + ".vcf.gz"
    cadd = popdata.write_cadd(phased["vcf"], str(tmp_path / "cadd.tsv.gz"),
                              gene_span=GENE_SPAN)
    argv = ["--geno_vcf", vcf, "--sample", "SAMPLE0"]
    if case != "no_cadd":
        argv += ["--cadd_file", cadd]
    if case == "cadd_af_vcf":
        argv += ["--af_vcf", phased["vcf"], "--af_field", "AF"]
    if case == "info_af":
        argv += ["--af_field", "DP"]
    a, b, rcs = _both(tmp_path, jax_annotate_main.main, annotate_main.main,
                      lambda o: argv + ["--o", o])
    assert rcs == [0, 0]
    _same_file(a, b)
    if case != "no_cadd":
        assert open(b).read().count("\n") > 1


# ---- the read -> variant mapper CLI ----------------------------------------

@pytest.mark.parametrize("seed,baseq,isize,splice",
                         [(0, 10, 0, 1), (1, 30, 0, 0), (2, 10, 400, 1)])
def test_mapper_main_matches_phaser_tpu(tmp_path, seed, baseq, isize, splice):
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=seed, contigs=("chr20", "chr21"),
        n_variants_per_contig=80, n_reads_per_contig=400,
        frac_spliced=0.3, frac_indel_reads=0.1)
    tpath, sam = popdata.mapper_inputs(vcf, bam, str(tmp_path), 10 ** 9)
    outs = []
    for name, m in (("jax", jax_mapper_main), ("port", mapper_main)):
        o = str(tmp_path / name)
        assert m.run(tpath, baseq, o, splice, isize, sam.splitlines()) == 0
        outs.append(o)
    _same_file(*outs)
    assert open(outs[1]).read().count("\n") > 50


def test_mapper_main_contig_mismatch(tmp_path, capsys):
    """A variant table contig the SAM does not know: both stop with exit
    code 1 at the same read and write the same partial rows."""
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=4, contigs=("chr20", "chr21"),
        n_variants_per_contig=60, n_reads_per_contig=300)
    tpath, sam = popdata.mapper_inputs(vcf, bam, str(tmp_path), 10 ** 9)
    with open(tpath) as f:
        text = f.read()
    with open(tpath, "w") as f:
        f.write(text.replace("chr21\t", "chrUn\t"))
    sam = sam.replace("SN:chr21", "SN:chr21x")
    outs = []
    for name, m in (("jax", jax_mapper_main), ("port", mapper_main)):
        o = str(tmp_path / name)
        assert m.run(tpath, 10, o, 1, 0, sam.splitlines()) == 1
        outs.append(o)
    _same_file(*outs)
    assert "Error, VCF and BAM contigs do not match" in capsys.readouterr().out


# ---- utils/table against pandas --------------------------------------------

TOKENS = ["", "NA", "nan", "N/A", "NULL", "1", "01", "-3", "+4", " 7", "7 ",
          "0", "-0", "1.5", "1e5", "1E+5", "1.", ".5", "5e", ".", "inf",
          "-Inf", "Infinity", "True", "false", "TRUE", "abc", "1|2", "0|0",
          "0x10", "1_000", "9223372036854775807", "9223372036854775808",
          "1e400", "0.30000000000000004", "00000000000000000001.5", "chr1",
          "ENSG0001.3", "a,b;c"]


def _random_table(rng, n_cols, n_rows):
    cols = []
    for _ in range(n_cols):
        # a few tokens per column so that every type gets whole columns
        pool = rng.choice(TOKENS, size=int(rng.integers(1, 4)))
        cols.append([str(rng.choice(pool)) for _ in range(n_rows)])
    header = ["c%d" % i for i in range(n_cols)]
    if rng.random() < 0.3:
        header[-1] = header[0]                      # repeated label
    if rng.random() < 0.3:
        header[1] = ""                              # unnamed
    lines = ["\t".join(header)]
    lines += ["\t".join(c[r] for c in cols) for r in range(n_rows)]
    if rng.random() < 0.3:
        lines.insert(2, "")                         # blank line
    if rng.random() < 0.3:
        lines[-1] = "\t".join(lines[-1].split("\t")[:2])   # short row
    return "\n".join(lines) + "\n"


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("seed", range(8))
def test_read_tsv_types_like_pandas(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        text = _random_table(rng, int(rng.integers(2, 6)),
                             int(rng.integers(1, 6)))
        df = pd.read_csv(io.StringIO(text), sep="\t", index_col=False)
        t = table.read_tsv(text=text)
        assert [str(c) for c in df.columns] == t.columns, text
        assert len(df) == len(t)
        for c in df.columns:
            want = df[c].tolist()
            got = t[c]
            assert len(want) == len(got)
            for w, g in zip(want, got):
                assert _same_value(g, w), (text, c, want, got)


@pytest.mark.parametrize("seed", range(4))
def test_write_tsv_formats_like_pandas(seed, tmp_path):
    rng = np.random.default_rng(100 + seed)
    pools = [[1, 2, -3], [0.1, 1e16, 1 / 3, -0.0, np.float64(2.5)],
             [1, float("nan")], [0.5, float("nan"), None],
             ["a", "b\tc", 'q"', None], [True, False], [True, None],
             ["x", 1, 2.5], [np.int64(4), 7], [None, None],
             [float("inf"), 1e-05, 123456789.0]]
    for _ in range(20):
        n_rows = int(rng.integers(0, 5))
        picks = [pools[int(i)] for i in rng.integers(0, len(pools), 4)]
        rows = [[p[int(rng.integers(0, len(p)))] for p in picks]
                for _ in range(n_rows)]
        labels = ["a", "b c", "#d", 5]
        want = pd.DataFrame(rows, columns=labels).to_csv(sep="\t",
                                                         index=False)
        p = str(tmp_path / "t.tsv")
        table.write_tsv(p, labels, rows)
        with open(p) as f:
            assert f.read() == want, rows


def test_table_comment_and_no_header_like_pandas():
    text = ("# header\n1\t2\t3#c\n\n 4\t5\t6\nx\t8\t9\n#\n7\t8\n")
    df = pd.read_csv(io.StringIO(text), sep="\t", header=None, comment="#")
    t = table.read_tsv(text=text, header=False, comment="#")
    for c in df.columns:
        assert all(_same_value(g, w) for g, w in zip(t[c], df[c].tolist()))
    with pytest.raises(ValueError):
        table.read_tsv(text="")
