"""The port's multiprocess shards over torch.distributed (Gloo): the
reducer's exact distributed percentile across three processes, the CLI's
--threads N --device host, engine processes on device "cpu", and resume
after a lost rank (tests/test_resume_multihost.py).  Outputs are held
against phaser_tpu run with device "host": the five text files byte for
byte, the VCF after BGZF decompression (the shard merge re-compresses the
VCF body, in phaser_tpu as here).

Every subprocess has its own communicate() timeout and every Gloo group
its own collective timeout, so a hung peer fails a test instead of the
suite."""

import filecmp
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.io import bgzf
from phaser_tpu_torch.dist.engine_multihost import (MultihostReducer,
                                                    run_phaser_multiproc)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = (".allelic_counts.txt", ".variant_connections.txt",
        ".allele_config.txt", ".haplotypes.txt", ".haplotypic_counts.txt")
GLOO_TIMEOUT = "120"      # seconds a collective waits for a peer
PROC_TIMEOUT = 300        # seconds a test waits for a subprocess


def _quiet(*a):
    pass


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def assert_same_content(a, b):
    for sfx in TEXT:
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), sfx
    assert bgzf.read_text_auto(a + ".vcf.gz") == \
        bgzf.read_text_auto(b + ".vcf.gz")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fixture(tmp_path, seed=31):
    """tests/test_resume_multihost.py's fixture."""
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=seed, contigs=("chr21", "chr22"),
        n_variants_per_contig=70, n_reads_per_contig=700)
    single = str(tmp_path / "host_single")
    jax_run_phaser(vcf=vcf, bam=bam, sample="SAMPLE1", o=single, mapq="10",
                   baseq=10, paired_end="1", opts=JaxOptions(),
                   device="host", log=_quiet)
    return vcf, bam, single


def _communicate(procs):
    outs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, outs


# ---------------------------------------------------------------------------
# the reducer

_PERCENTILE_WORKER = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist
from phaser_tpu_torch.dist.engine_multihost import MultihostReducer
rank, port, small = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
with open(sys.argv[4]) as fh:
    cases = json.load(fh)
dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                        rank=rank, world_size=3,
                        timeout=timedelta(seconds=120))
try:
    red = MultihostReducer({})
    assert (red.shard_id, red.n_shards) == (rank, 3)
    red._AS_SMALL = small
    out = []
    for shards, qs in cases:
        for q in qs:
            out.append(red.as_percentile(np.asarray(shards[rank]), q))
    print("RESULT " + json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def _percentile_cases():
    """tests/test_engine_multihost.py's adversarial cases, three shards
    each: ties, skew, empty shards, extreme ranges, a degenerate span."""
    rng = np.random.default_rng(7)
    cases = [
        ([rng.normal(40, 5, 5000), rng.normal(60, 1, 3000), np.zeros(0)],
         [0.0, 5.0, 37.3, 50.0, 95.0, 100.0]),
        ([np.repeat([1.0, 2.0, 2.0, 3.0], 2000), np.repeat([2.0], 4000),
          np.repeat([3.0], 100)], [5.0, 25.0, 50.0, 75.0]),
        ([np.zeros(0), rng.integers(0, 120, 9000).astype(np.float64),
          rng.integers(0, 120, 10).astype(np.float64)], [5.0, 50.0]),
        ([np.array([1e-30, 2e-30, 1e30]), rng.uniform(0, 1, 5000),
          np.array([0.5])], [5.0, 99.9]),
        ([np.full(3000, 7.25), np.full(2000, 7.25), np.zeros(0)],
         [5.0, 50.0]),
        ([rng.uniform(0, 1, 8000), np.array([0.5]), np.zeros(0)],
         [4.99999, 95.00001]),
        ([np.zeros(0), np.zeros(0), np.zeros(0)], [5.0]),
    ]
    return [([s.tolist() for s in shards], qs) for shards, qs in cases]


@pytest.mark.parametrize("small", [0, 8192], ids=["histogram", "gather"])
def test_as_percentile_over_three_gloo_processes(tmp_path, small):
    """MultihostReducer.as_percentile across 3 processes on a Gloo group:
    every rank returns np.percentile of the concatenation, bit for bit,
    through the histogram refinement and through the one-gather path."""
    cases = _percentile_cases()
    spec = str(tmp_path / "cases.json")
    with open(spec, "w") as fh:
        json.dump(cases, fh)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PERCENTILE_WORKER, str(r), str(port),
         str(small), spec], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(3)]
    rcs, outs = _communicate(procs)
    assert rcs == [0, 0, 0], [o[-1500:] for o in outs]
    want = []
    for shards, qs in cases:
        allv = np.concatenate([np.asarray(s, np.float64) for s in shards])
        want += [float(np.percentile(allv, q)) if allv.size else None
                 for q in qs]
    for out in outs:
        got = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        assert got == want


def test_reducer_without_process_group_is_one_shard():
    """One process, no group: the reducer is shard 0 of 1 and its
    collectives return this process's own payload."""
    red = MultihostReducer({"chr1": 0})
    assert (red.shard_id, red.n_shards) == (0, 1)
    assert red._allgather(("x", 1)) == [("x", 1)]
    v = np.random.default_rng(3).normal(0, 1, 20_000)
    assert red.as_percentile(v, 5.0) == float(np.percentile(v, 5.0))
    assert red.block_base(7) == 0 and red.noise(3, 4) == (3, 4)


# ---------------------------------------------------------------------------
# engine processes

def test_cli_threads_host_runs_processes(tmp_path, capsys):
    """`--threads 2 --device host`: two engine processes over Gloo, the
    merged totals in the summary, and phaser_tpu's single-process
    outputs."""
    vcf, bam, single = _fixture(tmp_path)
    out = str(tmp_path / "mp")
    rc = phaser_main.main(["--vcf", vcf, "--bam", bam, "--sample",
                           "SAMPLE1", "--mapq", "10", "--baseq", "10",
                           "--paired_end", "1", "--o", out, "--threads", "2",
                           "--device", "host"])
    stdout = capsys.readouterr().out
    assert rc == 0, stdout[-3000:]
    assert "COMPLETED using" in stdout and "across 2 processes" in stdout
    assert "shard device/wall seconds: " in stdout
    assert_same_content(out, single)
    assert not [f for f in os.listdir(str(tmp_path)) if ".shard" in f]


def test_multiproc_worker_failure_fails_the_run(tmp_path):
    """Workers that fail make the run raise with their output, and leave no
    merged outputs."""
    vcf, bam, _ = _fixture(tmp_path)
    with pytest.raises(RuntimeError, match="Sample 'NOPE' not found"):
        run_phaser_multiproc(2, vcf=vcf, bam=bam, sample="NOPE",
                             o=str(tmp_path / "mp"), mapq="10", baseq=10,
                             paired_end="1", opts=PhaserOptions(),
                             device="host", timeout_s=120, log=_quiet)
    assert not os.path.exists(str(tmp_path / "mp.haplotypes.txt"))


def _launch(vcf, bam, prefix, device="host", resume=False, die_rank=()):
    """Two `python -m phaser_tpu_torch.dist.engine_multihost` processes
    with position shards."""
    port = _free_port()
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "phaser_tpu_torch.dist.engine_multihost",
               "--bam", bam, "--vcf", vcf, "--sample", "SAMPLE1",
               "--o", prefix, "--num-processes", "2",
               "--process-id", str(pid), "--position-shards",
               "--device", device, "--timeout", GLOO_TIMEOUT,
               "--coordinator", "localhost:%d" % port]
        if resume:
            cmd.append("--resume")
        env = dict(os.environ, PYTHONPATH=REPO)
        if pid in die_rank:
            env["PHASER_TPU_TEST_EXIT_BEFORE_BARRIER"] = "1"
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return _communicate(procs)


def test_engine_processes_on_cpu_device(tmp_path):
    """Two engine processes with device "cpu" (the kernels' plain versions):
    the single-process outputs, and each process reports its own
    device-path seconds."""
    vcf, bam, single = _fixture(tmp_path)
    prefix = str(tmp_path / "mp")
    rcs, outs = _launch(vcf, bam, prefix, device="cpu")
    assert rcs == [0, 0], [o[-1500:] for o in outs]
    assert_same_content(prefix, single)
    for out in outs:
        done = [l for l in out.splitlines()
                if l.startswith("MULTIHOST_ENGINE_DONE")]
        assert done, out[-1500:]
        assert float(done[0].split("device_s=")[1].split()[0]) > 0.0


def _drop_shard0(prefix):
    """The state a crashed rank 0 leaves: its journal and outputs gone."""
    os.remove(prefix + ".shard0.ckpt")
    for sfx in [s[1:] for s in TEXT] + [
            "singletons.haplotypes.part", "singletons.haplotypic_counts.part",
            "allelic_counts.part", "vcf.gz", "vcfbody.gz", "vcfhdr.gz"]:
        p = prefix + ".shard0." + sfx
        if os.path.isfile(p):
            os.remove(p)


@pytest.mark.parametrize("lose_rank0", [True, False],
                         ids=["after_kill", "both_replay"])
def test_resume_after_lost_ranks(tmp_path, lose_rank0):
    """Both workers die after journaling, before the merge barrier.  On
    --resume, a rank with a complete journal replays it, a rank whose work
    was lost runs again, the two meet in the same collectives, and the
    merged outputs equal the single-process run's."""
    vcf, bam, single = _fixture(tmp_path)
    prefix = str(tmp_path / "mp")
    rcs, outs = _launch(vcf, bam, prefix, die_rank=(0, 1))
    assert rcs == [17, 17], (rcs, outs[0][-800:])
    assert os.path.isfile(prefix + ".shard1.ckpt")
    assert not os.path.isfile(prefix + ".haplotypes.txt")
    if lose_rank0:
        _drop_shard0(prefix)
    rcs, outs = _launch(vcf, bam, prefix, resume=True)
    assert rcs == [0, 0], (rcs, outs[0][-1500:], outs[1][-1500:])
    replayed = ["replaying" in o for o in outs]
    assert replayed == [not lose_rank0, True], replayed
    assert_same_content(prefix, single)
    # journals are consumed by the successful merge
    assert not os.path.isfile(prefix + ".shard1.ckpt")


# ---------------------------------------------------------------------------
# no card

def _runner_call(name, vcf, bam, o):
    from phaser_tpu_torch.dist.engine_multihost import (
        run_phaser_multihost, run_phaser_sharded_threads)
    from phaser_tpu_torch.engine.slow_mode import run_phaser_slow
    run = dict(vcf=vcf, bam=bam, sample="SAMPLE1", o=o, mapq="10", baseq=10,
               paired_end="1", opts=PhaserOptions(), device="cuda",
               log=_quiet)
    if name == "threads":
        run_phaser_sharded_threads(n_shards=2, position_shards=True, **run)
    elif name.startswith("slow"):
        run_phaser_slow(threads=int(name[-1]), **run)
    elif name == "multihost":
        run_phaser_multihost(num_processes=1, process_id=0, **run)
    elif name == "multiproc":
        run_phaser_multiproc(2, timeout_s=120, **run)
    else:  # two engine processes, each on its own
        rcs, outs = _launch(vcf, bam, o, device="cuda")
        assert rcs[0] != 0 and rcs[1] != 0, rcs
        for out in outs:
            assert "needs a CUDA GPU" in out, out[-1500:]
        raise RuntimeError("every process: needs a CUDA GPU")


@pytest.mark.parametrize("name", ["threads", "slow1", "slow2", "multihost",
                                  "multiproc", "processes"])
def test_cuda_without_a_card_fails_every_runner(tmp_path, name):
    """--device cuda on a machine without a card: every runner, shard and
    engine process raises, and no output is written."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=33, contigs=("chr21", "chr22"),
        n_variants_per_contig=20, n_reads_per_contig=100)
    o = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        _runner_call(name, vcf, bam, o)
    assert not [f for f in os.listdir(str(tmp_path)) if f.startswith("out")]
