"""The port's CLI on bench_engine.py's fixture, uncut: seed 77, 1M input
reads over chr1 / chr2 / chr3 at 60 / 25 / 15%, error rate 0.01
(bench_engine.py:43-53).  The six output files of the port's CLI with
--device host and with --device cpu (the kernels' plain versions) must equal
phaser_tpu's run_phaser(device="host") byte for byte.  The fixture's size is
the check, so it is not cut; it is written once for the module."""

import filecmp
import os

import pytest

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.cli import phaser_main

N_READS = 1_000_000          # bench_engine.py's input reads (ENG_READS)
SHARES = (0.6, 0.25, 0.15)   # of the reads on chr1, chr2, chr3
SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """bench_engine.py's fixture and phaser_tpu's host run on it."""
    d = tmp_path_factory.mktemp("bench_engine")
    pairs = [int(N_READS // 2 * s) for s in SHARES]
    lens = [max(250_000, p * 12) for p in pairs]
    nvar = [max(100, p // 40) for p in pairs]
    vcf, bam, data = datagen.write_fixture_dir(
        str(d), seed=77, contigs=("chr1", "chr2", "chr3"), contig_len=lens,
        n_variants_per_contig=nvar, n_reads_per_contig=pairs,
        error_rate=0.01)
    ref = str(d / "phaser_tpu")
    jax_run_phaser(vcf=vcf, bam=bam, sample=data.sample, o=ref, mapq="10",
                   baseq=10, paired_end="1", device="host",
                   opts=PhaserOptions(), log=lambda *a: None)
    with open(ref + ".allelic_counts.txt") as f:
        assert sum(1 for _ in f) > 5000
    return dict(vcf=vcf, bam=bam, sample=data.sample, dir=d, ref=ref)


@pytest.mark.parametrize("device", ["host", "cpu"])
def test_cli_matches_phaser_tpu_on_bench_fixture(bench, device, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE",
                       str(bench["dir"] / ("cache_" + device)))
    out = str(bench["dir"] / device)
    rc = phaser_main.main(
        ["--vcf", bench["vcf"], "--bam", bench["bam"], "--sample",
         bench["sample"], "--mapq", "10", "--baseq", "10", "--paired_end",
         "1", "--o", out, "--device", device])
    assert rc == 0, capsys.readouterr().out[-2000:]
    for sfx in SUFFIXES:
        assert os.path.getsize(out + sfx) > 0, sfx
        assert filecmp.cmp(out + sfx, bench["ref"] + sfx, shallow=False), sfx
