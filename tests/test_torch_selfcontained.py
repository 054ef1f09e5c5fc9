"""phaser_tpu_torch stands on its own: with jax, jaxlib, phaser_tpu and
pandas refused by the import system every module imports, the three
runners finish and so do the five downstream CLIs; no source line imports
them; and the native IO library builds once and loads whole when several
processes ask for it at the same moment."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "phaser_tpu_torch")

# refuses the JAX packages, the JAX implementation of phaser and pandas
REFUSE = '''
import sys

class _Refuse:
    names = ("jax", "jaxlib", "phaser_tpu", "pandas")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("refused in this test: " + name)
        return None

sys.meta_path.insert(0, _Refuse())
'''


def _run(code, tmp_path, timeout=600, **env):
    env = dict(os.environ, PYTHONPATH=REPO,
               PHASER_TPU_TORCH_CACHE=str(tmp_path / "cache"), **env)
    code = REFUSE + "REFUSE_SRC = %r\n" % REFUSE + code
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_every_module_imports_without_jax_or_phaser_tpu(tmp_path):
    out = _run('''
import importlib, pkgutil
import phaser_tpu_torch
n = 0
for m in pkgutil.walk_packages(phaser_tpu_torch.__path__, "phaser_tpu_torch."):
    importlib.import_module(m.name)
    n += 1
bad = [k for k in sys.modules if k.split(".")[0] in _Refuse.names]
assert not bad, bad
try:
    import phaser_tpu
except ImportError:
    print("MODULES", n)
''', tmp_path)
    assert int(out.split("MODULES")[1]) >= 40


RUNNERS = {
    "single": [],
    "threads": ["--threads", "2"],
    "process_slow": ["--process_slow", "1"],
}


@pytest.mark.parametrize("runner", sorted(RUNNERS))
def test_runner_finishes_without_jax_or_phaser_tpu(tmp_path, runner):
    """The CLI on a phaser_tpu_torch.testing.datagen fixture with
    --device cpu, through each runner; the outputs are written and equal
    the single run's where the runner promises that."""
    out = _run('''
import filecmp, os
from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.testing import datagen
d = %r
vcf, bam, data = datagen.write_fixture_dir(
    d, seed=5, contigs=("chr20", "chr21"), contig_len=15000,
    n_variants_per_contig=60, n_reads_per_contig=500)
base = ["--vcf", vcf, "--bam", bam, "--sample", data.sample, "--mapq", "10",
        "--baseq", "10", "--paired_end", "1", "--device", "cpu"]
flags = %r
assert phaser_main.main(base + ["--o", os.path.join(d, "run")] + flags) == 0
text = (".allelic_counts.txt", ".variant_connections.txt",
        ".allele_config.txt", ".haplotypes.txt", ".haplotypic_counts.txt")
for sfx in text + (".vcf.gz", ".vcf.gz.tbi"):
    assert os.path.getsize(os.path.join(d, "run" + sfx)) > 0, sfx
if "--threads" in flags:
    assert phaser_main.main(base + ["--o", os.path.join(d, "one")]) == 0
    for sfx in text:
        assert filecmp.cmp(os.path.join(d, "run" + sfx),
                           os.path.join(d, "one" + sfx), shallow=False), sfx
bad = [k for k in sys.modules if k.split(".")[0] in _Refuse.names]
assert not bad, bad
print("RUNNER_OK")
''' % (str(tmp_path), RUNNERS[runner]), tmp_path)
    assert "RUNNER_OK" in out and "COMPLETED" in out


TOOLS = {
    "gene_ae": "gene_ae_main",
    "expr_matrix": "expr_matrix_main",
    "cis_var": "cis_var_main",
    "annotate": "annotate_main",
    "read_variant_map": "mapper_main",
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_downstream_cli_finishes_without_jax_pandas_or_phaser_tpu(tmp_path,
                                                                  tool):
    """`python -m phaser_tpu_torch.cli.<tool>` in a process that refuses
    jax, phaser_tpu and pandas, on inputs made by the port's own fixture
    generators: exit code 0 and a well-formed output."""
    d = str(tmp_path)
    out = _run('''
import os, runpy, subprocess
import numpy as np
from phaser_tpu_torch.cli import expr_matrix_main
from phaser_tpu_torch.testing import datagen, popdata
d, tool = %r, %r
rng = np.random.default_rng(1)
gdir, features = popdata.make_gene_ae_dir(d, rng, 6, 20)
vcf, bam, data = datagen.write_fixture_dir(
    d, seed=3, contigs=("chr20",), contig_len=20000,
    n_variants_per_contig=60, n_reads_per_contig=300)
o = os.path.join(d, "out")
stdin = None
if tool == "gene_ae":
    argv = ["--haplotypic_counts", popdata.make_hap_counts(d, rng, 20),
            "--features", features, "--o", o]
elif tool == "expr_matrix":
    argv = ["--gene_ae_dir", gdir, "--features", features, "--o", o]
elif tool == "cis_var":
    assert expr_matrix_main.main(["--gene_ae_dir", gdir, "--features",
                                  features, "--o", os.path.join(d, "m")]) == 0
    pv, pairs, smap = popdata.make_cis_var_inputs(d, rng, 6, 20, 12)
    argv = ["--bed", os.path.join(d, "m.gw_phased.bed.gz"), "--vcf", pv,
            "--pairs", pairs, "--map", smap, "--o", o, "--bs", "200",
            "--min_cov", "2", "--engine", "numpy"]
elif tool == "annotate":
    cadd = popdata.write_cadd(vcf, os.path.join(d, "cadd.tsv.gz"),
                              gene_span=1500)
    argv = ["--geno_vcf", vcf, "--sample", data.sample, "--cadd_file", cadd,
            "--o", o]
else:
    table, sam = popdata.mapper_inputs(vcf, bam, d, 400)
    argv = ["--variant_table", table, "--baseq", "10", "--o", o]
    stdin = sam
code = REFUSE_SRC + "import runpy; runpy.run_module(%%r, run_name='__main__')"
res = subprocess.run(
    [sys.executable, "-c", code %% ("phaser_tpu_torch.cli." + %r)] + argv,
    input=stdin, capture_output=True, text=True, timeout=300,
    env=dict(os.environ))
assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
if tool == "expr_matrix":
    from phaser_tpu_torch.io import bgzf, tabix
    for sfx in (".bed.gz", ".gw_phased.bed.gz"):
        rows = bgzf.read_text_auto(o + sfx).decode().splitlines()
        assert len(rows) == 21 and len(rows[0].split("\\t")) == 10, rows[0]
        got = list(tabix.TabixFile(o + sfx).fetch("chr20", 0, 10 ** 6))
        assert got == rows[1:], (got[:2], rows[1:3])
else:
    with open(o) as f:
        lines = f.read().splitlines()
    assert len(lines) > 1, lines
    width = len(lines[0].split("\\t"))
    assert all(len(l.split("\\t")) == width for l in lines), tool
bad = [k for k in sys.modules if k.split(".")[0] in _Refuse.names]
assert not bad, bad
print("TOOL_OK")
''' % (d, tool, TOOLS[tool]), tmp_path)
    assert "TOOL_OK" in out


PORT_SCRIPTS = ["phaser-torch", "phaser-torch-gene-ae",
                "phaser-torch-expr-matrix", "phaser-torch-cis-var",
                "phaser-torch-annotate", "phaser-torch-read-variant-map"]


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_console_script_names_a_port_main(script):
    """pyproject.toml installs each port CLI under a name of its own, and
    the entry point is the `main` of a phaser_tpu_torch module."""
    import importlib
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        project = tomllib.load(fh)["project"]
    target = project["scripts"][script]
    module, func = target.split(":")
    assert module.startswith("phaser_tpu_torch.cli.")
    assert callable(getattr(importlib.import_module(module), func))
    assert project["optional-dependencies"]["torch"] == ["torch"]
    assert not any(v.startswith("phaser_tpu_torch")
                   for k, v in project["scripts"].items()
                   if not k.startswith("phaser-torch"))


def test_no_source_line_imports_jax_or_phaser_tpu():
    pat = re.compile(
        r"^\s*(from|import)\s+(phaser_tpu|jax|jaxlib|pandas)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    found = []
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if pat.match(line):
                    found.append("%s:%d: %s" % (os.path.relpath(path, REPO),
                                                i, line.strip()))
    assert not found, "\n".join(found)


def _build_into(bdir):
    """Script lines that point the build module at another directory."""
    return '''
import os
from phaser_tpu_torch.utils import build
build.BUILD_DIR = %r
build.LIB_PATH = os.path.join(build.BUILD_DIR, "libphaser_kernels.so")
build.IO_LIB_PATH = os.path.join(build.BUILD_DIR, "libphaser_io.so")
''' % str(bdir)


LOAD = '''
from phaser_tpu_torch.io import native
from phaser_tpu_torch.utils import build
lib = native.get_lib()
assert lib is not None and lib.bgzf_compress_bound(100) > 100
print("LOADED built=%d path=%s" % (build.last_io_build_seconds is not None,
                                   build.IO_LIB_PATH))
'''


def test_native_library_builds_once_for_concurrent_processes(tmp_path):
    """Four processes ask for the native IO library from an empty build
    directory at once: all four load it, and exactly one compiled it."""
    bdir = str(tmp_path / "_build")
    env = dict(os.environ, PYTHONPATH=REPO)
    code = REFUSE + _build_into(bdir) + LOAD
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "LOADED" in out, out + err[-3000:]
        assert ("path=" + bdir) in out
    assert sum("built=1" in out for out, _ in outs) == 1, outs
    left = sorted(os.listdir(bdir))
    assert left == ["libphaser_io.so", "libphaser_io.so.lock"], left


def test_read_only_install_builds_into_the_cache(tmp_path):
    """The package's _build/ cannot be made (its parent is a file, which
    no user, root included, can create a directory under): the IO library
    is built into $PHASER_TPU_TORCH_CACHE/build and loaded from there, and
    the kernel library's path follows it."""
    blocker = tmp_path / "package"
    blocker.write_text("a file where the package directory would be")
    code = ("from phaser_tpu_torch.utils import build\n"
            "build.PKG_BUILD_DIR = %r\n" % str(blocker / "_build") + LOAD +
            'print("KERNELS", build.LIB_PATH)\n')
    out = _run(code, tmp_path)
    cache = str(tmp_path / "cache" / "build")
    assert "built=1" in out and ("path=%s/libphaser_io.so" % cache) in out
    assert ("KERNELS %s/libphaser_kernels.so" % cache) in out
    assert sorted(os.listdir(cache)) == ["libphaser_io.so",
                                         "libphaser_io.so.lock"]


def test_native_library_that_does_not_load_is_rebuilt(tmp_path):
    """A library file that is newer than the source but does not load (one
    carried over from another machine) is built again, not worked around."""
    bdir = tmp_path / "_build"
    bdir.mkdir()
    (bdir / "libphaser_io.so").write_bytes(b"not a shared library")
    out = _run(_build_into(bdir) + LOAD, tmp_path)
    assert "built=1" in out
    assert (bdir / "libphaser_io.so").stat().st_size > 10_000


def test_no_native_env_is_the_one_way_without_the_library(tmp_path):
    out = _run('''
from phaser_tpu_torch.io import native
assert native.get_lib() is None
print("NONE")
''', tmp_path, PHASER_TPU_NO_NATIVE="1")
    assert "NONE" in out


def test_native_build_failure_raises(tmp_path):
    """Without a compiler the loader raises: no silent pure-Python run."""
    bdir = tmp_path / "_build"
    out = _run(_build_into(bdir) + '''
from phaser_tpu_torch.io import native
try:
    native.get_lib()
except RuntimeError as e:
    print("RAISED", e)
''', tmp_path, PATH="/nonexistent")
    assert "RAISED building the native IO library failed" in out
