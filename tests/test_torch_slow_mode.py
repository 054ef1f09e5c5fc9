"""The port's --process_slow mode against phaser_tpu's run_phaser_slow
(device "host"), byte for byte: the per-contig merge, --resume, position
shards per contig, and the CLI.  Unlike phaser_tpu, the port skips a
contig only when it has nothing to phase; any other RuntimeError (a
missing card, a failed build, a device fault) fails the run."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import pytest

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.slow_mode import run_phaser_slow as jax_run_slow
from phaser_tpu_torch.engine import slow_mode
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.engine.pipeline import run_phaser
from phaser_tpu_torch.engine.slow_mode import run_phaser_slow


def _jax_opts(opts):
    """phaser_tpu's own options object with the port options' values."""
    return JaxOptions(**dataclasses.asdict(opts))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")
RUN = dict(mapq="10", baseq=10, paired_end="1")


def _quiet(*a):
    pass


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def assert_same_bytes(a, b):
    for sfx in SUFFIXES:
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), sfx


def _fixture(tmp_path, seed=61, contig_len=15000, n_var=60, n_reads=800):
    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=seed, contigs=("chr20", "chr21"),
        contig_len=contig_len, n_variants_per_contig=n_var,
        n_reads_per_contig=n_reads)
    return vcf, bam, data.sample


def _jax_slow(tmp_path, vcf, bam, sample, opts, **kw):
    ref = str(tmp_path / "jax_slow")
    jax_run_slow(vcf=vcf, bam=bam, sample=sample, o=ref,
                 opts=_jax_opts(opts),
                 device="host", log=_quiet, **RUN, **kw)
    return ref


@pytest.mark.parametrize("device", ["host", "cpu"])
def test_slow_mode_merge_matches_phaser_tpu(tmp_path, device):
    vcf, bam, sample = _fixture(tmp_path)
    opts = PhaserOptions(as_q_cutoff=0)
    want = _jax_slow(tmp_path, vcf, bam, sample, opts)
    got = str(tmp_path / "slow")
    res = run_phaser_slow(vcf=vcf, bam=bam, sample=sample, o=got, opts=opts,
                          device=device, log=_quiet, **RUN)
    assert_same_bytes(got, want)
    assert res.total_reads > 0 and len(res.shard_device) == 2
    assert not os.path.exists(got + "chr20.haplotypes.txt")


def test_slow_mode_resume_matches_phaser_tpu(tmp_path):
    """An interrupted run (only chr20 finished) resumed: the same bytes as
    phaser_tpu's uninterrupted slow run."""
    vcf, bam, sample = _fixture(tmp_path, seed=62, contig_len=12000,
                                n_var=50, n_reads=600)
    opts = PhaserOptions(as_q_cutoff=0)
    want = _jax_slow(tmp_path, vcf, bam, sample, opts)
    part = str(tmp_path / "part")
    run_phaser(vcf=vcf, bam=bam, sample=sample, o=part + "chr20",
               chrom="chr20", opts=opts, device="cpu", log=_quiet, **RUN)
    run_phaser_slow(vcf=vcf, bam=bam, sample=sample, o=part, opts=opts,
                    device="cpu", resume=True, log=_quiet, **RUN)
    assert_same_bytes(part, want)


def test_slow_mode_position_shards_matches_phaser_tpu(tmp_path):
    """threads=3: every contig through three position-shard threads, the
    same bytes as phaser_tpu's single-threaded slow run, and neither
    per-contig nor per-shard files left behind."""
    vcf, bam, sample = _fixture(tmp_path, seed=63, n_reads=900)
    want = _jax_slow(tmp_path, vcf, bam, sample, PhaserOptions())
    got = str(tmp_path / "s3")
    res = run_phaser_slow(vcf=vcf, bam=bam, sample=sample, o=got,
                          opts=PhaserOptions(), device="cpu", threads=3,
                          log=_quiet, **RUN)
    assert_same_bytes(got, want)
    assert len(res.shard_device) == 6
    leftovers = [f for f in os.listdir(str(tmp_path))
                 if ".shard" in f or "s3chr" in f]
    assert not leftovers, leftovers


@pytest.mark.parametrize("threads", [1, 3])
def test_slow_mode_skips_contig_without_hets(tmp_path, threads):
    """A blacklist that covers chr21 leaves it no het site: phaser_tpu
    skips the contig, and so does the port, alone (NoHetSites) or through
    position shards (NoReadsMatched at the global noise reduction)."""
    vcf, bam, sample = _fixture(tmp_path)
    bed = str(tmp_path / "chr21.bed")
    with open(bed, "w") as fh:
        fh.write("chr21\t0\t1000000\n")
    want = _jax_slow(tmp_path, vcf, bam, sample, PhaserOptions(),
                     blacklist=bed)
    got = str(tmp_path / "slow")
    lines = []
    run_phaser_slow(vcf=vcf, bam=bam, sample=sample, o=got,
                    opts=PhaserOptions(), device="cpu", threads=threads,
                    blacklist=bed, log=lines.append, **RUN)
    assert_same_bytes(got, want)
    assert any(l.startswith("     contig chr21 skipped") for l in lines)
    with open(got + ".allelic_counts.txt") as fh:
        assert "chr21" not in fh.read()


@pytest.mark.parametrize("threads", [1, 2])
def test_slow_mode_propagates_device_errors(tmp_path, monkeypatch, threads):
    """A RuntimeError other than "nothing to phase" in one contig fails the
    whole slow run: no contig is silently dropped."""
    from phaser_tpu_torch.dist import engine_multihost
    vcf, bam, sample = _fixture(tmp_path)
    real = run_phaser

    def broken(**kw):
        if kw.get("chrom") == "chr21" or "chr21" in getattr(
                kw.get("shard_plan"), "own", ()):
            raise RuntimeError("device 'cuda' needs a CUDA GPU")
        return real(**kw)

    monkeypatch.setattr(slow_mode, "run_phaser", broken)
    monkeypatch.setattr(engine_multihost, "run_phaser", broken)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        run_phaser_slow(vcf=vcf, bam=bam, sample=sample,
                        o=str(tmp_path / "slow"), opts=PhaserOptions(),
                        device="cpu", threads=threads, log=_quiet, **RUN)
    assert not os.path.exists(str(tmp_path / "slow.haplotypes.txt"))


def test_cli_slow_cpu_without_jax(tmp_path):
    """`--process_slow 1 --device cpu` through the port's CLI in a fresh
    process: phaser_tpu's slow-mode bytes, and jax never imported."""
    vcf, bam, sample = _fixture(tmp_path)
    want = _jax_slow(tmp_path, vcf, bam, sample, PhaserOptions())
    out = str(tmp_path / "cli")
    argv = ["--vcf", vcf, "--bam", bam, "--sample", sample, "--mapq", "10",
            "--baseq", "10", "--paired_end", "1", "--o", out,
            "--process_slow", "1", "--device", "cpu"]
    code = ("import sys\n"
            "from phaser_tpu_torch.cli.phaser_main import main\n"
            "rc = main(%r)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n" % argv)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "Memory efficient mode is activated" in proc.stdout
    assert_same_bytes(out, want)
