"""The port's cis_var against phaser_tpu's, on the CPU.

* The numpy engine: whole output files byte-equal to phaser_tpu's numpy
  engine (the same per-pair seeded resampling), on the committed
  examples/cis_var_example inputs read in place, on pop-benchmark-shaped
  inputs, and on one case for each pandas behaviour the output carries.
* The torch engine (--device cpu): the deterministic columns (every column
  but the four CI pairs and var_het_pval) byte-equal to phaser_tpu's numpy
  and jax engines; the CI bounds within 2.0 of the numpy engine's, with
  lower <= point <= upper (tests/test_cis_var_jax.py's model); the same
  seed gives the same file.
* The engine choice: auto below the crossover imports no torch; torch on
  the card, and auto above the crossover with --device cuda, raise without
  a card; --engine jax is not an engine of the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from phaser_tpu.analysis.cis_var import run_cis_var as jax_run_cis_var
from phaser_tpu.cli import cis_var_main as jax_cis_var_main
from phaser_tpu_torch.analysis import cis_var
from phaser_tpu_torch.cli import cis_var_main, expr_matrix_main
from phaser_tpu_torch.io import bgzf
from phaser_tpu_torch.testing import popdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "cis_var_example")

# every column but the CI bounds and var_het_pval (tests/test_cis_var_jax.py)
DET = ["gene", "var_id", "var_chr", "var_pos", "var_het_n", "var_hom_n",
       "het_hom_pvalue", "var_het_afc", "var_het_abs_afc", "var_hom_afc",
       "var_hom_abs_afc", "var_het_afcs", "var_hom_afcs",
       "var_het_ref_counts", "var_het_alt_counts", "var_hom_hap1_counts",
       "var_hom_hap2_counts", "var_het_sample_ids", "var_hom_sample_ids"]


def _quiet(*a, **k):
    pass


def _example():
    return dict(bed=os.path.join(EXAMPLE, "matrix.gw_phased.bed.gz"),
                vcf=os.path.join(EXAMPLE, "merged.vcf.gz"),
                pairs=os.path.join(EXAMPLE, "test_pairs.txt"),
                map=os.path.join(EXAMPLE, "sample_map.txt"),
                flags=["--ignore_v", "1", "--bs", "1000", "--bs_seed", "1"])


def _pop(tmp_path, n_samples=24, n_genes=10, n_pairs=30, seed=8):
    """pop-benchmark-shaped inputs; the matrix made by the port's
    expr_matrix, written out as plain text so that cases can edit it."""
    rng = np.random.default_rng(seed)
    d, features = popdata.make_gene_ae_dir(str(tmp_path), rng, n_samples,
                                           n_genes)
    mat = str(tmp_path / "matrix")
    assert expr_matrix_main.main(["--gene_ae_dir", d, "--features",
                                  features, "--o", mat]) == 0
    bed = str(tmp_path / "matrix.bed")
    with open(bed, "wb") as f:
        f.write(bgzf.read_text_auto(mat + ".gw_phased.bed.gz"))
    vcf, pairs, smap = popdata.make_cis_var_inputs(str(tmp_path), rng,
                                                   n_samples, n_genes,
                                                   n_pairs)
    return dict(bed=bed, vcf=vcf, pairs=pairs, map=smap,
                flags=["--bs", "300", "--bs_seed", "3", "--min_cov", "4"])


def _edit(path, fn):
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(fn(text))


def _edit_rows(path, fn):
    """fn(row index, cells) -> cells, for every line but the header."""
    def go(text):
        lines = text.rstrip("\n").split("\n")
        out = [lines[0]]
        for i, l in enumerate(lines[1:]):
            out.append("\t".join(fn(i, l.split("\t"))))
        return "\n".join(out) + "\n"
    _edit(path, go)


def _rewrite_vcf(path, fn):
    from phaser_tpu_torch.io import tabix
    text = bgzf.read_text_auto(path).decode()
    bgzf.compress_to_path(fn(text).encode(), path)
    tabix.build_vcf_index(path)


def _quirk(tmp_path, case):
    x = _pop(tmp_path)
    if case == "var_ref_empty":
        # an empty var_ref is NaN, "nan" != "": the ref/alt test fails and
        # the match falls back to var_id
        _edit_rows(x["pairs"], lambda i, c: c[:4] + [""] + c[5:]
                   if i % 3 == 0 else c)
    elif case == "numeric_var_id":
        # numeric ids are read as int and never equal the VCF's string ID;
        # without ref/alt columns nothing matches: a header-only result
        _rewrite_vcf(x["vcf"], lambda t: t.replace("\tvar", "\t"))
        _edit_rows(x["pairs"], lambda i, c: c[:1] + [c[1][3:]] + c[2:4])
        _edit(x["pairs"], lambda t: t.replace("\tvar_ref\tvar_alt", ""))
    elif case == "numeric_vcf_sample":
        # numeric sample names never meet the VCF header's strings: every
        # cohort is empty, the CI columns NaN (written empty)
        _rewrite_vcf(x["vcf"], lambda t: t.replace("\tS", "\t1"))
        _edit_rows(x["map"], lambda i, c: ["1" + c[0][1:], c[1]])
    elif case == "matrix_empty_cell":
        # an empty cell is "nan" after astype(str) and makes the sample
        # ineligible for that gene
        _edit_rows(x["bed"], lambda i, c: c[:5] + [""] + c[6:]
                   if i % 2 else c)
    elif case == "var_id_nan":
        # a numeric var_id column with a gap is float: ids print as "3.0",
        # the gap as an empty field (matching goes by ref/alt)
        _rewrite_vcf(x["vcf"], lambda t: t.replace("\tvar", "\t"))
        _edit_rows(x["pairs"], lambda i, c: c[:1] + [
            "" if i == 4 else c[1][3:]] + c[2:])
    elif case == "chr_filter":
        x["flags"] += ["--chr", "chr20"]
    elif case == "chr_absent":
        x["flags"] += ["--chr", "chr21"]      # no pair: a RuntimeError
    else:
        raise KeyError(case)
    return x


def _argv(x, o, engine, device=None):
    argv = ["--bed", x["bed"], "--vcf", x["vcf"], "--pairs", x["pairs"],
            "--map", x["map"], "--o", o, "--engine", engine] + x["flags"]
    return argv + (["--device", device] if device else [])


QUIRKS = ["var_ref_empty", "numeric_var_id", "numeric_vcf_sample",
          "matrix_empty_cell", "var_id_nan", "chr_filter", "chr_absent"]


@pytest.mark.parametrize("case", ["example", "popdata"] + QUIRKS)
def test_numpy_engine_matches_phaser_tpu(tmp_path, case):
    if case == "example":
        x = _example()
    elif case == "popdata":
        x = _pop(tmp_path)
    else:
        x = _quirk(tmp_path, case)
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    ra = jax_cis_var_main.main(_argv(x, a, "numpy"))
    rb = cis_var_main.main(_argv(x, b, "numpy"))
    assert ra == rb
    if case == "chr_absent":
        assert rb == 1 and not os.path.exists(b)
        return
    assert rb == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        want = fa.read()
        assert fb.read() == want
    lines = want.decode().splitlines()
    if case == "numeric_var_id":
        assert len(lines) == 1                    # the header only
    else:
        assert len(lines) > 5
    if case == "var_id_nan":
        ids = [l.split("\t")[1] for l in lines[1:]]
        assert "3.0" in ids and "" in ids
    if case == "numeric_vcf_sample":
        assert all(l.split("\t")[4:6] == ["0", "0"] for l in lines[1:])


def _columns(path):
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split("\t")
    rows = [l.split("\t") for l in lines[1:]]
    return {h: [r[i] for r in rows] for i, h in enumerate(head)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """phaser_tpu's numpy and jax engines and the port's torch engine on
    the CPU, on pop-benchmark-shaped inputs (80 samples, 40 pairs)."""
    tmp = tmp_path_factory.mktemp("engines")
    x = _pop(tmp, n_samples=80, n_genes=10, n_pairs=40)
    kw = dict(bs=500, min_cov=4, log=_quiet)
    out = {}
    for name, run in (("numpy", lambda o: jax_run_cis_var(
            x["bed"], x["vcf"], x["pairs"], x["map"], o, engine="numpy",
            **kw)),
                      ("jax", lambda o: jax_run_cis_var(
            x["bed"], x["vcf"], x["pairs"], x["map"], o, engine="jax",
            **kw)),
                      ("torch", lambda o: cis_var.run_cis_var(
            x["bed"], x["vcf"], x["pairs"], x["map"], o, engine="torch",
            device="cpu", **kw))):
        o = str(tmp / (name + ".txt"))
        run(o)
        out[name] = o
    return x, out


@pytest.mark.parametrize("other", ["numpy", "jax"])
def test_torch_engine_det_columns_equal_phaser_tpu(engines, other):
    _, out = engines
    A, B = _columns(out[other]), _columns(out["torch"])
    assert list(A) == list(B)
    for c in DET:
        assert A[c] == B[c], c
    assert len(A["gene"]) == 40


def test_torch_engine_ci_within_noise(engines):
    _, out = engines
    A, B = _columns(out["numpy"]), _columns(out["torch"])
    n = np.array(B["var_het_n"], int)
    m = n > 3
    assert m.sum() > 10

    def col(T, c):
        return np.array([float(v) if v else np.nan for v in T[c]])
    for c in ("var_het_afc_lower", "var_het_afc_upper",
              "var_hom_afc_lower", "var_hom_afc_upper"):
        assert np.nanmax(np.abs(col(A, c) - col(B, c))[m]) < 2.0, c
    lo, mid, hi = (col(B, c)[m] for c in ("var_het_afc_lower",
                                          "var_het_afc",
                                          "var_het_afc_upper"))
    assert (lo <= mid + 1e-6).all() and (mid <= hi + 1e-6).all()
    p = col(B, "var_het_pval")[m]
    assert ((0 <= p) & (p <= 1)).all()


def test_torch_engine_same_seed_same_file(tmp_path, engines):
    x, out = engines
    again = str(tmp_path / "again.txt")
    other = str(tmp_path / "other.txt")
    kw = dict(bs=500, min_cov=4, log=_quiet, engine="torch", device="cpu")
    cis_var.run_cis_var(x["bed"], x["vcf"], x["pairs"], x["map"], again,
                        **kw)
    cis_var.run_cis_var(x["bed"], x["vcf"], x["pairs"], x["map"], other,
                        bs_seed=1, **kw)
    with open(out["torch"], "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    A, C = _columns(out["torch"]), _columns(other)
    assert A["var_het_afc_lower"] != C["var_het_afc_lower"]
    for c in DET:
        assert A[c] == C[c]


@pytest.mark.parametrize("engine,device,n_pairs,bs,want", [
    ("numpy", "cuda", 10 ** 6, 10 ** 6, "numpy"),
    ("torch", "cpu", 1, 1, "torch"),
    ("auto", "cpu", 10 ** 6, 10 ** 6, "numpy"),
    ("auto", "cuda", 0, 10000, "numpy"),
    ("auto", "cuda", 10 ** 6, 10000, "torch"),
])
def test_resolve_engine(engine, device, n_pairs, bs, want):
    assert cis_var.resolve_engine(engine, device, n_pairs, bs) == want


def test_auto_crossover_is_the_boundary():
    n = cis_var.AUTO_CROSSOVER // 1000
    assert cis_var.resolve_engine("auto", "cuda", n, 1000) == (
        "torch" if n * 1000 >= cis_var.AUTO_CROSSOVER else "numpy")
    assert cis_var.resolve_engine("auto", "cuda", n + 1, 1000) == "torch"
    assert cis_var.resolve_engine("auto", "cuda", n - 1, 1000) == "numpy"


def test_torch_on_the_card_raises_without_one(tmp_path, monkeypatch):
    """--engine torch and auto above the crossover, with --device cuda and
    no card: an error before any work, never a numpy run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _example()
    o = str(tmp_path / "out.txt")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cis_var.run_cis_var(x["bed"], x["vcf"], x["pairs"], x["map"], o,
                            engine="torch", device="cuda", log=_quiet)
    monkeypatch.setattr(cis_var, "AUTO_CROSSOVER", 1)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cis_var.run_cis_var(x["bed"], x["vcf"], x["pairs"], x["map"], o,
                            engine="auto", device="cuda", log=_quiet)
    assert cis_var_main.main(_argv(x, o, "torch")) == 1
    assert not os.path.exists(o) and os.path.exists(o + ".failure.json")
    assert cis_var_main.main(_argv(x, o, "torch", "cpu")) == 0
    assert os.path.exists(o)


def test_engine_jax_is_rejected(tmp_path, capsys):
    x = _example()
    with pytest.raises(SystemExit) as e:
        cis_var_main.main(_argv(x, str(tmp_path / "o.txt"), "jax"))
    assert e.value.code == 2
    assert "invalid choice: 'jax'" in capsys.readouterr().err


REFUSE_TORCH = '''
import sys

class _Refuse:
    names = ("jax", "jaxlib", "phaser_tpu", "pandas", "torch")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("refused in this test: " + name)
        return None

sys.meta_path.insert(0, _Refuse())
from phaser_tpu_torch.analysis import cis_var
from phaser_tpu_torch.cli import cis_var_main
assert cis_var.resolve_engine("auto", "cuda", 8, 1000) == "numpy"
rc = cis_var_main.main(sys.argv[1:])
assert rc == 0, rc
bad = [k for k in sys.modules if k.split(".")[0] in _Refuse.names]
assert not bad, bad
print("AUTO_NUMPY_OK")
'''


def test_auto_below_crossover_imports_no_torch(tmp_path):
    """An auto run that resolves to numpy, with torch (and jax, phaser_tpu,
    pandas) refused by the import system: it finishes and imports none."""
    x = _example()
    o = str(tmp_path / "out.txt")
    res = subprocess.run(
        [sys.executable, "-c", REFUSE_TORCH] + _argv(x, o, "auto", "cuda"),
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "AUTO_NUMPY_OK" in res.stdout
    want = str(tmp_path / "numpy.txt")
    assert cis_var_main.main(_argv(x, want, "numpy")) == 0
    with open(o, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
