"""The port's --threads runners against phaser_tpu run with device "host":
run_phaser's contig pool, run_phaser_sharded_threads with contig and
position shards (engine threads of one process, as they share one card on
--device cuda), and the CLI's --threads N --device cpu.

Each sharded run's six files equal phaser_tpu's run of the same runner
byte for byte, and the single-process host run's files: the five text
files byte for byte, the VCF after BGZF decompression (the shard merge
re-compresses the VCF body, in phaser_tpu as here)."""

import dataclasses
import filecmp
import os
import re
import subprocess
import sys
import threading

import pytest

import datagen
from phaser_tpu.dist.engine_multihost import \
    run_phaser_sharded_threads as jax_sharded
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.dist.engine_multihost import run_phaser_sharded_threads
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.io import bgzf
from phaser_tpu_torch.engine import blocks, connections, phasing
from phaser_tpu_torch.engine.pipeline import run_phaser


def _jax_opts(opts):
    """phaser_tpu's own options object with the port options' values."""
    return JaxOptions(**dataclasses.asdict(opts))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = (".allelic_counts.txt", ".variant_connections.txt",
        ".allele_config.txt", ".haplotypes.txt", ".haplotypic_counts.txt")
RUN = dict(sample="SAMPLE1", mapq="10", baseq=10, paired_end="1")


def _quiet(*a):
    pass


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def assert_same_bytes(a, b):
    for sfx in TEXT + (".vcf.gz",):
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), sfx


def assert_same_content(a, b):
    for sfx in TEXT:
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), sfx
    assert bgzf.read_text_auto(a + ".vcf.gz") == \
        bgzf.read_text_auto(b + ".vcf.gz")


def _fixture(tmp_path, **kw):
    """tests/test_engine_multihost.py's fixture."""
    kw.setdefault("contigs", ("chr19", "chr20", "chr21", "chr22"))
    kw.setdefault("n_variants_per_contig", 60)
    kw.setdefault("n_reads_per_contig", 500)
    kw.setdefault("seed", 11)
    return datagen.write_fixture_dir(str(tmp_path), **kw)[:2]


def _skewed_fixture(tmp_path):
    """chr1 carries ~78% of the reads (tests/test_engine_multihost.py)."""
    return datagen.write_fixture_dir(
        str(tmp_path), seed=21, contigs=("chr1", "chr2"),
        contig_len=(150000, 40000), n_variants_per_contig=(160, 40),
        n_reads_per_contig=(1800, 500))[:2]


def _empty_shards_fixture(tmp_path):
    return datagen.write_fixture_dir(
        str(tmp_path), seed=61, contigs=("chrA", "chrB"),
        contig_len=(30000, 30000), n_variants_per_contig=(30, 30),
        n_reads_per_contig=(200, 200))[:2]


def _host_single(tmp_path, vcf, bam, opts=None):
    ref = str(tmp_path / "host_single")
    jax_run_phaser(vcf=vcf, bam=bam, o=ref,
                   opts=_jax_opts(opts or PhaserOptions()),
                   device="host", log=_quiet, **RUN)
    return ref


def _check_sharded(tmp_path, vcf, bam, n_shards, position_shards,
                   opts=None, device="cpu"):
    """The port's sharded run on `device` against phaser_tpu's sharded run
    and single-process run, both on the host."""
    opts = opts or PhaserOptions()
    want = str(tmp_path / "jax_sharded")
    jax_sharded(n_shards=n_shards, vcf=vcf, bam=bam, o=want,
                opts=_jax_opts(opts),
                device="host", position_shards=position_shards, log=_quiet,
                **RUN)
    got = str(tmp_path / "port_sharded")
    res = run_phaser_sharded_threads(
        n_shards=n_shards, vcf=vcf, bam=bam, o=got, opts=opts,
        device=device, position_shards=position_shards, log=_quiet, **RUN)
    assert_same_bytes(got, want)
    assert_same_content(got, _host_single(tmp_path, vcf, bam, opts))
    assert not [f for f in os.listdir(str(tmp_path)) if ".shard" in f]
    return res


@pytest.mark.parametrize("device", ["host", "cpu"])
@pytest.mark.parametrize("threads", [2, 4])
def test_run_phaser_threads_matches_phaser_tpu_host(tmp_path, threads,
                                                    device):
    """run_phaser(threads=t): the contig pool over host stages (device
    launches stay serial on a non-host device)."""
    vcf, bam = _fixture(tmp_path)
    out = str(tmp_path / "port")
    run_phaser(vcf=vcf, bam=bam, o=out, opts=PhaserOptions(), threads=threads,
               device=device, log=_quiet, **RUN)
    assert_same_bytes(out, _host_single(tmp_path, vcf, bam))


@pytest.mark.parametrize("n_shards,contigs,multibam", [
    (2, ("chr19", "chr20", "chr21", "chr22"), False),
    (3, ("chr19", "chr20", "chr21", "chr22"), True),
    (5, ("chr21", "chr22"), False),
])
def test_contig_shards_match_phaser_tpu(tmp_path, n_shards, contigs,
                                        multibam):
    """Contig shards: balanced, unbalanced with the same BAM given twice
    (the bam-major row-sequence interleave), and more shards than
    contigs."""
    vcf, bam = _fixture(tmp_path, contigs=contigs)
    if multibam:
        bam = bam + "," + bam
    res = _check_sharded(tmp_path, vcf, bam, n_shards, False)
    assert res.total_reads > 0
    assert len(res.shard_device) == min(n_shards, len(contigs))


@pytest.mark.parametrize("n_shards,make", [(4, _skewed_fixture),
                                           (16, _empty_shards_fixture)])
def test_position_shards_match_phaser_tpu(tmp_path, n_shards, make):
    """Position shards: 4 over two skewed contigs (the big one split), and
    16 over a small fixture, where empty shards still reach every
    collective in order."""
    vcf, bam = make(tmp_path)
    res = _check_sharded(tmp_path, vcf, bam, n_shards, True)
    assert len(res.shard_device) == n_shards
    for dev_s, wall_s in res.shard_device:
        assert 0.0 <= dev_s <= wall_s


@pytest.mark.parametrize("opts", [
    PhaserOptions(gw_phase_vcf=1),
    PhaserOptions(gw_phase_vcf=2, gw_phase_vcf_min_confidence=0.99),
    PhaserOptions(output_read_ids=1),
    PhaserOptions(unique_ids=1),
], ids=["gw_phase_vcf1", "gw_phase_vcf2", "output_read_ids", "unique_ids"])
def test_position_shards_flag_matrix(tmp_path, opts):
    """tests/test_engine_multihost.py:310-340's writer options under three
    position shards."""
    vcf, bam = _fixture(tmp_path)
    _check_sharded(tmp_path, vcf, bam, 3, True, opts=opts)


def test_position_shards_cpu_gates_down(tmp_path, monkeypatch):
    """Device "cpu" with the pair, edge and scorer gates forced down: every
    shard thread runs stages #3-#5 through their torch code, the counts add
    up across threads, and the outputs stay equal."""
    monkeypatch.setattr(connections, "DEVICE_PAIR_GATE", 0)
    monkeypatch.setattr(blocks, "_DEVICE_EDGE_GATE", 0)
    monkeypatch.setattr(phasing, "DEVICE_SCORE_GATE", 2)
    for counts in (connections.COUNTS, blocks.COUNTS, phasing.COUNTS):
        monkeypatch.setitem(counts, "device_calls", 0)
    # read errors leave blocks that only the 2^n scorer phases
    vcf, bam = _fixture(tmp_path, seed=51, contigs=("chr20", "chr21"),
                        contig_len=20000, n_variants_per_contig=100,
                        n_reads_per_contig=1500, error_rate=0.01)
    _check_sharded(tmp_path, vcf, bam, 4, True)
    calls = [c["device_calls"] for c in
             (connections.COUNTS, blocks.COUNTS, phasing.COUNTS)]
    assert min(calls) > 0, calls


def test_failing_shard_aborts_its_peers(tmp_path, monkeypatch):
    """One shard's device failure breaks its peers' collectives: the run
    raises that failure instead of hanging or finishing without the
    shard."""
    from phaser_tpu_torch.engine import pipeline
    vcf, bam = _fixture(tmp_path)
    lock = threading.Lock()
    calls = []
    real = pipeline.assign_alleles_auto

    def flaky(*a, **k):
        with lock:
            calls.append(1)
            first = len(calls) == 1
        if first:
            raise RuntimeError("CUDA error 700 (illegal address)")
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "assign_alleles_auto", flaky)
    errors = []

    def run():
        try:
            run_phaser_sharded_threads(
                n_shards=3, vcf=vcf, bam=bam, o=str(tmp_path / "out"),
                device="cpu", position_shards=True, log=_quiet, **RUN)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the sharded run hung after a shard failed"
    assert len(errors) == 1 and re.search(r"shard \d failed: CUDA error 700",
                                          str(errors[0])), errors
    assert not os.path.exists(str(tmp_path / "out.haplotypes.txt"))


@pytest.mark.parametrize("threads", [3, 4])
def test_cli_threads_cpu_without_jax(tmp_path, threads):
    """`--threads N --device cpu` through the port's CLI in a fresh
    process: N position-shard threads, the launch and stage-call lines and
    one device/wall pair per shard, outputs equal to phaser_tpu's, and jax
    never imported."""
    vcf, bam = _fixture(tmp_path)
    want = str(tmp_path / "jax_sharded")
    jax_sharded(n_shards=threads, vcf=vcf, bam=bam, o=want, opts=JaxOptions(),
                device="host", position_shards=True, log=_quiet, **RUN)
    out = str(tmp_path / "cli")
    argv = ["--vcf", vcf, "--bam", bam, "--sample", "SAMPLE1", "--mapq",
            "10", "--baseq", "10", "--paired_end", "1", "--o", out,
            "--threads", str(threads), "--device", "cpu"]
    code = ("import sys\n"
            "from phaser_tpu_torch.cli.phaser_main import main\n"
            "rc = main(%r)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n" % argv)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "sharded engine: %d position shards (threads, device=cpu)" \
        % threads in proc.stdout
    assert re.search(r"kernel launches: affine_nibble=0 ", proc.stdout)
    assert re.search(r"device stage calls: pair_counts=0 components=0 "
                     r"phase_scores=0", proc.stdout)
    assert re.search(r"shard device/wall seconds: (\S+/\S+ ){%d}\S+/\S+\n"
                     % (threads - 1), proc.stdout)
    assert_same_bytes(out, want)
    assert_same_content(out, _host_single(tmp_path, vcf, bam))
