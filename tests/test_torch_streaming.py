"""The port's streaming decode: a BAM above PHASER_TPU_STREAM_THRESHOLD_MB
is decoded in windows on the prefetch thread and #2 is launched once a
window and contig.  With windows of a few BGZF blocks, which cut mate
pairs and contigs apart, the CLI's six outputs are byte-equal to a whole
decode's and to phaser_tpu's host run; the `decode window` spans count
the file's reads and bytes; the main thread's waits and the producer's
blocked time are spans of their own."""

import contextlib
import dataclasses
import filecmp
import io
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import datagen
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.io import bam as bamio
from phaser_tpu_torch.io import bgzf
from phaser_tpu_torch.utils import prefetch, trace
from phaser_tpu_torch.utils.memtune import bgzf_uncompressed_size

SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")
BLOCKS = 2          # BGZF blocks a window


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("PHASER_TPU_PROFILE_DIR", raising=False)
    monkeypatch.delenv("PHASER_TPU_STREAM_THRESHOLD_MB", raising=False)
    trace.clear_spans()
    yield
    trace.clear_spans()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(vcf, bam, sample, phaser_tpu's host outputs) of two contigs."""
    d = str(tmp_path_factory.mktemp("stream_fixture"))
    vcf, bam, data = datagen.write_fixture_dir(
        d, seed=53, contigs=("chr20", "chr21"), contig_len=15000,
        n_variants_per_contig=70, n_reads_per_contig=900)
    ref = os.path.join(d, "jax_host")
    jax_run_phaser(vcf=vcf, bam=bam, sample=data.sample, o=ref, mapq="10",
                   baseq=10, paired_end="1",
                   opts=JaxOptions(**dataclasses.asdict(PhaserOptions())),
                   device="host", log=lambda *x: None)
    return vcf, bam, data.sample, ref


def _window_bytes(bam):
    with open(bam, "rb") as fh:
        offs = bgzf.block_offsets(fh.read())
    assert len(offs) > 4 * BLOCKS
    return offs[BLOCKS] - offs[0]


def _small_windows(monkeypatch, bam):
    """Every BAM streams, in windows of BLOCKS blocks."""
    width = _window_bytes(bam)
    whole_window = bamio.iter_bam_stream
    monkeypatch.setenv("PHASER_TPU_STREAM_THRESHOLD_MB", "0")
    monkeypatch.setattr(bamio, "iter_bam_stream",
                        lambda path, **kw: whole_window(
                            path, window_bytes=width, **kw))


def _cli(fixture, out, device):
    vcf, bam, sample, _ = fixture
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = phaser_main.main(
            ["--vcf", vcf, "--bam", bam, "--sample", sample, "--mapq", "10",
             "--baseq", "10", "--paired_end", "1", "--o", out,
             "--device", device])
    assert rc == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _assert_same_outputs(a, b):
    for suffix in SUFFIXES:
        assert filecmp.cmp(a + suffix, b + suffix, shallow=False), suffix


def test_small_windows_cut_mate_pairs_and_contigs(fixture):
    """The windows the tests stream in: several, with a contig's reads and
    some mate pairs split across two of them."""
    _, bam, _, _ = fixture
    chunks = list(bamio.iter_bam_stream(bam,
                                        window_bytes=_window_bytes(bam)))
    assert len(chunks) >= 4
    assert sum(len(c) for c in chunks) == len(bamio.read_bam(bam))
    contigs_cut = pairs_cut = 0
    for a, b in zip(chunks, chunks[1:]):
        contigs_cut += int(a.refid[-1]) == int(b.refid[0])
        pairs_cut += bool(set(a.names) & set(b.names))
    assert contigs_cut >= 2 and pairs_cut >= 2
    assert any(len(set(c.refid.tolist())) == 2 for c in chunks)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_streamed_outputs_equal_whole_decode_and_phaser_tpu(
        fixture, tmp_path, monkeypatch, device):
    whole = str(tmp_path / "whole")
    out = _cli(fixture, whole, device)
    assert "streaming decode" not in out
    _small_windows(monkeypatch, fixture[1])
    streamed = str(tmp_path / "streamed")
    out = _cli(fixture, streamed, device)
    assert "streaming decode" in out
    _assert_same_outputs(streamed, whole)
    _assert_same_outputs(streamed, fixture[3])


def test_stream_spans_count_the_files_reads_and_bytes(
        fixture, tmp_path, monkeypatch):
    """Under a profiler: the `decode window` spans (prefetch thread) sum to
    the BAM's records, size and uncompressed size; each main-thread wait
    counts one `stream_waits`, one a window and one for the end; `prefetch
    blocked` spans lie on the prefetch thread, inside the run."""
    _, bam, _, _ = fixture
    _small_windows(monkeypatch, bam)
    with profile(activities=[ProfilerActivity.CPU]):
        _cli(fixture, str(tmp_path / "o"), "cpu")
    spans = trace.recorded_spans()
    run, = [s for s in spans if s.name == "phaser run"]
    windows = [s for s in spans if s.name == "decode window"]
    assert {s.thread for s in windows} == {"phaser-tpu-prefetch"}
    assert all(s.run == run.run and s.parent == run.id for s in windows)
    total = {k: sum(s.counts[k] for s in windows)
             for k in ("reads", "bytes_in", "bytes_out")}
    assert total == {"reads": len(bamio.read_bam(bam)),
                     "bytes_in": os.path.getsize(bam),
                     "bytes_out": bgzf_uncompressed_size(bam)}
    n_chunks = sum(s.counts["reads"] > 0 for s in windows)
    assert n_chunks >= 4
    waits = [s for s in spans if s.name == "#2 bam decode"]
    assert all(s.thread == run.thread for s in waits)
    assert [s.counts for s in waits] == \
        [{"stream_waits": 1}] * (n_chunks + 1)
    assert sum(s.items for s in waits) == total["reads"]
    for s in spans:
        if s.name == "prefetch blocked":
            assert s.thread == "phaser-tpu-prefetch" and s.run == run.run
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns


def test_whole_decode_waits_count_nothing(fixture, tmp_path):
    """Below the threshold `#2 bam decode` is the whole decode: no counters,
    no window and no blocked span."""
    with profile(activities=[ProfilerActivity.CPU]):
        _cli(fixture, str(tmp_path / "o"), "cpu")
    spans = trace.recorded_spans()
    decode, = [s for s in spans if s.name == "#2 bam decode"]
    assert decode.counts is None
    assert not [s for s in spans
                if s.name in ("decode window", "prefetch blocked")]


def test_streams_run_on_one_reused_producer_thread():
    """Streams one after another, an abandoned one among them, run on the
    same pooled producer thread (so its allocator arena, which holds the
    decoded windows, serves each of them), named as before and a daemon,
    which never holds the interpreter's exit."""
    def producer(n):
        for _ in range(n):
            yield threading.current_thread()

    def settle():                      # the last producer returns to idle
        time.sleep(0.5)

    first = set(prefetch.iter_prefetch(producer(3)))
    settle()
    abandoned = prefetch.iter_prefetch(producer(1000), depth=1)
    second = {next(abandoned)}
    abandoned.close()
    settle()
    third = set(prefetch.iter_prefetch(producer(2)))
    assert first == second == third
    thread, = first
    assert thread.name == "phaser-tpu-prefetch" and thread.daemon


def test_a_full_queue_is_a_blocked_span():
    """A producer that fills the queue while the consumer is slow records
    `prefetch blocked` on its thread, under the caller's span; the
    consumer's takes are counted, the end included."""
    before = prefetch.consumer_counts()["stream_waits"]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("caller") as caller:
            got = []
            for x in prefetch.iter_prefetch(range(6), depth=1,
                                            parent=caller):
                time.sleep(0.02)
                got.append(x)
    assert got == list(range(6))
    assert prefetch.consumer_counts()["stream_waits"] - before == 7
    blocked = [s for s in trace.recorded_spans()
               if s.name == "prefetch blocked"]
    assert blocked
    for s in blocked:
        assert s.thread == "phaser-tpu-prefetch" and s.parent == caller.id
        assert s.seconds > 0


def test_stager_counts_waits_for_a_busy_slot():
    """`_Stager.reserve` counts a wait only where the slot's last copy has
    not finished, and waits for it."""
    from phaser_tpu_torch.mapper import dispatch

    class Copy:
        def __init__(self, done):
            self.done, self.waited = done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = True

    st = dispatch._Stager()
    busy, done = Copy(False), Copy(True)
    st._events[:2] = [busy, done]
    st._bufs[:2] = [torch.empty(1 << 16, dtype=torch.uint8)
                    for _ in range(2)]
    before = dispatch.STATS["stager_waits"]
    st.reserve(16)
    st.reserve(16)
    assert dispatch.STATS["stager_waits"] - before == 1
    assert busy.waited and not done.waited
