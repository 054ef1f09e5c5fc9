"""The port's multi-process scaffolding on the CPU: the multihost CLI over a
Gloo group of two processes against phaser_tpu's single-process
multiprocess_allele_counts (counts equal, tolerance 0; the JSON line
byte-equal), a rank whose position shard holds no read, position_shards
against phaser_tpu's, both scaling benches at small sizes, and the dry run
(dist/dryrun.py) against __graft_entry__.py's host recomputations.

Every subprocess has its own communicate() timeout and every Gloo group its
own collective timeout, so a hung peer fails a test instead of the suite."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import __graft_entry__ as graft
from phaser_tpu.dist import multihost as JH
from phaser_tpu.dist import scaling_bench as JS
from phaser_tpu_torch.dist import (dryrun, engine_scaling_bench, multihost,
                                   scaling_bench)
from phaser_tpu_torch.testing import datagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 300        # seconds a test waits for a subprocess
GLOO_TIMEOUT = "120"      # seconds a collective waits for a peer


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multihost_cli(bam, vcf, n, out0):
    """n `python -m phaser_tpu_torch.dist.multihost --device cpu` ranks;
    returns rank 0's stdout."""
    port = _free_port()
    procs = []
    for pid in range(n):
        cmd = [sys.executable, "-m", "phaser_tpu_torch.dist.multihost",
               "--bam", bam, "--vcf", vcf, "--sample", "SAMPLE1",
               "--num-processes", str(n), "--process-id", str(pid),
               "--coordinator", "localhost:%d" % port, "--device", "cpu",
               "--timeout", GLOO_TIMEOUT]
        if pid == 0:
            cmd += ["--o", out0]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs[0]


def _payload(counts):
    return json.dumps({"n_vars": int(counts.shape[0]),
                       "total_hits": int(counts.sum()),
                       "counts": counts.tolist()})


def test_multihost_cli_two_processes_equal_jax(tmp_path):
    """tests/test_kernels.py:309-343 on the port: two Gloo ranks, each
    packing its own position shard, merge to phaser_tpu's single-process
    counts; the --o file and the MULTIHOST_RESULT line are phaser_tpu's
    JSON byte for byte."""
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=5, n_variants_per_contig=60,
        n_reads_per_contig=400, contig_len=60000)
    out0 = str(tmp_path / "mh0.json")
    stdout = _multihost_cli(bam, vcf, 2, out0)
    c1 = JH.multiprocess_allele_counts(bam, vcf, "SAMPLE1", 1, 0)
    assert c1.sum() > 0
    with open(out0) as f:
        assert f.read() == _payload(c1) + "\n"
    assert "MULTIHOST_RESULT " + _payload(c1) in stdout.splitlines()
    c_port = multihost.multiprocess_allele_counts(bam, vcf, "SAMPLE1", 1, 0,
                                                  device="cpu")
    np.testing.assert_array_equal(c_port, c1)


def test_multihost_rank_with_an_empty_shard(tmp_path):
    """Every read starts in the second half of the span, so rank 0's shard
    is empty; it still joins the all_reduce and the counts are whole."""
    data = datagen.generate(seed=8, contigs=("chr20",), contig_len=60000,
                            n_variants_per_contig=200, n_reads_per_contig=400)
    vcf = str(tmp_path / "sample.vcf.gz")
    bam = str(tmp_path / "late.bam")
    data.write_vcf(vcf)
    last = int(multihost.device_table(vcf, "SAMPLE1", "")[0].max())
    late = [r for r in data.bam_records if 0.55 * last < r.pos <= last]
    late = late[:len(late) - len(late) % 8]   # phaser_tpu's 8-device mesh
    from phaser_tpu_torch.io import bam as bamio
    bamio.write_bam(bam, data.contigs,
                    [data.contig_lens[c] for c in data.contigs], late)
    bd = bamio.read_bam(bam)
    span = int(bd.pos.max()) + 1
    shard0 = multihost.position_shards(span, 2, halo=0)[0]
    assert len(multihost.local_read_selection(bd, shard0)) == 0
    out0 = str(tmp_path / "mh0.json")
    _multihost_cli(bam, vcf, 2, out0)
    c1 = JH.multiprocess_allele_counts(bam, vcf, "SAMPLE1", 1, 0)
    assert c1.sum() > 0
    with open(out0) as f:
        np.testing.assert_array_equal(np.array(json.load(f)["counts"]), c1)


def test_position_shards_and_selection_match_jax():
    for length, n, halo in ((10000, 4, 200), (10001, 3, 0), (7, 8, 1000),
                            (123456, 5, 1000)):
        assert list(multihost.position_shards(length, n, halo)) == \
            list(JH.position_shards(length, n, halo))

    class BD:
        pos = np.array([0, 5, 99, 100, 250, 4000, 9999], np.int32)
    for shard in ((0, 100), (100, 4000), (4000, 10000)):
        np.testing.assert_array_equal(
            multihost.local_read_selection(BD, shard),
            JH.local_read_selection(BD, shard))


def test_initialize_single_process_does_nothing(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("PHASER_TPU_NUM_PROCESSES", raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not dist.is_initialized()


def test_run_sharded_step_single_process():
    """tests/test_kernels.py:197-222 on the port's local mesh."""
    from phaser_tpu_torch.dist.mesh import make_mesh
    rng = np.random.default_rng(3)
    N, L, M = 64, 128, 32
    codes = rng.integers(0, 16, (N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, (N, L)).astype(np.uint8)
    refpos = np.sort(rng.integers(1, 3000, (N, L)).astype(np.int32), axis=1)
    vpos = np.sort(rng.choice(np.arange(1, 3000), M, replace=False)
                   ).astype(np.int32)
    ind = rng.integers(1, 15, (M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    counts, pair, prune, scores = multihost.run_sharded_step(
        make_mesh(8, device="cpu"), codes, quals, refpos, vpos, ind, ni, 10)
    assert tuple(counts.shape) == (M, 3)
    assert tuple(prune.shape) == (M, 8)
    assert int(counts.sum()) > 0


def test_scaling_bench_cpu_matches_jax_hits(capsys):
    """tests/test_kernels.py:286-300's sizes: 1 and 2 Gloo ranks; the hit
    totals equal phaser_tpu's sharded counts on the same _gen data."""
    import jax
    from phaser_tpu.dist.mesh import make_mesh, sharded_allele_counts
    for a, b in zip(scaling_bench._gen(512, 32, 64), JS._gen(512, 32, 64)):
        np.testing.assert_array_equal(a, b)
    rc = scaling_bench.main(["--devices", "1,2", "--reads-per-device", "256",
                             "--read-len", "32", "--variants", "64",
                             "--iters", "2", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(l.startswith("CHILD_RESULT ") for l in lines) == 2
    res = json.loads(lines[-1])
    assert res["metric"] == "weak_scaling_efficiency"
    assert res["unit"] == "fraction" and res["value"] > 0
    for n in (1, 2):
        per = res["per_device"][str(n)]
        assert per["reads"] == 256 * n and per["device"] == "cpu"
        want = sharded_allele_counts(make_mesh(n),
                                     *JS._gen(256 * n, 32, 64), 10)
        assert per["hits"] == int(np.asarray(jax.device_get(want)).sum()) > 0


def test_engine_scaling_bench_cpu(tmp_path, capsys):
    """Strong scaling at n = 1, 2 engine processes (--device cpu): the
    bench itself asserts every output equal to the n = 1 run's."""
    out = str(tmp_path / "scaling.json")
    rc = engine_scaling_bench.main(["--reads", "400", "--ns", "1,2",
                                    "--device", "cpu", "--out", out])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == res
    assert set(res["strong"]) == {"1", "2"} and res["device"] == "cpu"
    assert res["strong"]["1"]["efficiency"] == 1.0
    assert len(res["strong"]["2"]["shard_wall_s"]) == 2
    assert res["headline"]["metric"] == "engine_strong_scaling_efficiency_2"


def test_dryrun_multichip_cpu():
    dryrun.dryrun_multichip(2, "cpu")


def test_dryrun_entry_matches_graft_entry():
    """The single-device forward step equals __graft_entry__.entry()'s."""
    fn, args = dryrun.entry("cpu")
    jfn, jargs = graft.entry()
    want = np.asarray(jfn(*jargs))
    got = fn(*args).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_dryrun_host_recomputations_equal_graft_entry():
    """The copies of __graft_entry__'s numpy recomputations give its
    numbers on the dense scaling-bench layout."""
    args = scaling_bench._gen(128, 64, 256)
    for a, b in zip(dryrun._example_tensors(n_reads=32, n_vars=40, seed=2),
                    graft._example_tensors(n_reads=32, n_vars=40, seed=2)):
        np.testing.assert_array_equal(a, b)
    c, p = dryrun._host_counts_band(*args, 10, 8)
    gc, gp = graft._host_counts_band(*args, 10, 8)
    np.testing.assert_array_equal(c, gc)
    np.testing.assert_array_equal(p, gp)
    assert p.sum() > 0
    np.testing.assert_array_equal(dryrun._host_scores(p, 6, 8),
                                  graft._host_scores(gp, 6, 8))
    for x, y in zip(dryrun._host_prune(c, p, 0.01),
                    graft._host_prune(gc, gp, 0.01)):
        np.testing.assert_array_equal(x, y)
