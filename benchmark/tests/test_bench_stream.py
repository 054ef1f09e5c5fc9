"""The streaming cell's deployment cut small (`dna_rna_1kg_chr22`): the
WGS BAM over a lowered streaming threshold, in windows small enough that
a pass takes several, against the plain reference; and the three
streaming readers (metrics/stream_*.py) over the spans of two such passes
under a CPU profiler, and on synthetic and missing spans."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import sys
import time
import types

import pytest

from conftest import small_config
from gen import make
from reference import pipeline
from reference.compare import compare

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
METRICS = os.path.join(BENCH, "metrics")
if METRICS not in sys.path:
    sys.path.insert(0, METRICS)

import _spans  # noqa: E402

SEED = 2 ** 31 + 23
SCALE = 0.015          # 605 kbp of chr22, 121 k DNA and 18 k RNA reads
WINDOW = 1 << 20       # compressed bytes a window: several a pass
THRESHOLD_MB = "10"    # the DNA BAM streams, the RNA BAM is decoded whole


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_test_" + name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


decode_s, wait_s, blocked_s = (
    _reader(n) for n in ("stream_decode_s", "stream_wait_s",
                         "stream_blocked_s"))


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Two passes of the port's CLI (`--device cpu`) under a CPU profiler,
    the WGS BAM streamed in small windows: (config, input dir, manifest,
    the last pass's output prefix, pass walls, recorded spans, each
    pass's stdout)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from phaser_tpu_torch.cli import phaser_main
    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.utils import trace
    cfg, mix = small_config("dna_rna_1kg_chr22", SCALE)
    d = str(tmp_path_factory.mktemp("chr22"))
    man = make.make(cfg, mix, SEED, d, threads=2)
    whole_window = bamio.iter_bam_stream
    argv = (["--bam", ",".join(os.path.join(d, b) for b in man["bams"]),
             "--vcf", os.path.join(d, man["vcf"]), "--sample", cfg["sample"]]
            + cfg["flags"] + ["--device", "cpu"])
    walls, outs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHASER_TPU_TORCH_CACHE", os.path.join(d, "cache"))
        mp.setenv("PHASER_TPU_STREAM_THRESHOLD_MB", THRESHOLD_MB)
        mp.setattr(bamio, "iter_bam_stream", lambda path, **kw: whole_window(
            path, window_bytes=WINDOW, **kw))
        trace.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            for k in range(2):
                buf = io.StringIO()
                s = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    assert phaser_main.main(
                        argv + ["--o", os.path.join(d, "p%d" % k)]) == 0
                walls.append((s, time.perf_counter()))
                outs.append(buf.getvalue())
        spans = trace.recorded_spans()
        trace.clear_spans()
    return (cfg, mix, d, man, os.path.join(d, "p1"), walls, spans, outs)


def test_streamed_cut_equals_the_reference(streamed):
    cfg, mix, d, man, port, _, _, outs = streamed
    out = outs[-1]
    assert man["uncompressed_bytes"][0] > float(THRESHOLD_MB) * 1e6 > \
        man["uncompressed_bytes"][1]
    assert out.count("streaming decode") == 1
    donor, sets = make.inputs(cfg, mix, SEED)
    pipeline.run(cfg, donor, sets, d + "/ref")
    res = compare(port, d + "/ref")
    assert res == {"rows_differ": 0, "real_gap": 0.0, "files_missing": 0}
    assert os.path.getsize(port + ".allelic_counts.txt") > 1000


def test_stream_readers_on_the_ports_passes(streamed, monkeypatch):
    """Positive, each under the pass's wall; the waits are the `#2 bam
    decode` spans less the RNA BAM's whole decode; the windows count the
    WGS BAM's reads."""
    cfg, _, _, man, _, walls, spans, _ = streamed
    monkeypatch.setattr(_spans, "recorded", lambda: spans)
    ctx = {"spans": walls}
    mean_wall = sum(e - s for s, e in walls) / len(walls)
    got = {"decode": decode_s(ctx), "wait": wait_s(ctx),
           "blocked": blocked_s(ctx)}
    for k, v in got.items():
        assert 0 < v < mean_wall, (k, got, mean_wall)
    decodes = [s for s in spans if s.name == "#2 bam decode"]
    whole = [s for s in decodes if not s.counts]
    assert len(whole) == 2             # the RNA BAM, once a pass
    assert got["wait"] == pytest.approx(
        sum(s.seconds for s in decodes if s.counts) / 2)
    windows = [s for s in spans if s.name == "decode window"]
    assert sum(s.counts["reads"] for s in windows) == 2 * man["reads"][0]
    assert sum(s.counts["reads"] > 0 for s in windows) >= 2 * 4


ACCEPTED = ("vcf_s", "decode_s", "assign_s", "graph_s", "output_s",
            "unspanned_s", "glue_s", "untraced_s", "prefilter_kept_pct",
            "device_idle", "ragged_join_roofline")


def test_accepted_readers_on_the_ports_passes(streamed, monkeypatch):
    """The pass readers that the other cells list read a streamed pass as
    they read a whole decode: the stages and the glue positive and under
    the pass's wall, the pre-filter's share a percentage.  The glue and
    the untraced time are the main thread's, so the prefetch thread's
    windows move neither; the device readers find no trace on the CPU."""
    from harness import stages
    _, _, _, _, _, walls, spans, outs = streamed
    read = {n: _reader(n) for n in ACCEPTED}
    ctx = {"spans": walls, "stages": [stages.parse(o) for o in outs],
           "trace": None, "join_work": None}
    mean_wall = sum(e - s for s, e in walls) / len(walls)
    monkeypatch.setattr(_spans, "recorded", lambda: spans)
    got = {n: r(ctx) for n, r in read.items()}
    for n in ("vcf_s", "decode_s", "assign_s", "graph_s", "output_s",
              "glue_s", "untraced_s"):
        assert 0 < got[n] < mean_wall, (n, got)
    assert abs(got["unspanned_s"]) < mean_wall
    assert 0 < got["prefilter_kept_pct"] <= 100
    assert got["device_idle"] is None and got["ragged_join_roofline"] is None
    prefetch = {s.thread for s in spans if s.name == "decode window"}
    assert prefetch and "MainThread" not in prefetch
    main_only = [s for s in spans if s.thread not in prefetch]
    monkeypatch.setattr(_spans, "recorded", lambda: main_only)
    for n in ("glue_s", "untraced_s", "prefilter_kept_pct"):
        assert read[n](ctx) == got[n], n


def test_stream_readers_without_a_stream(monkeypatch):
    """No counted `decode window` in the window's runs (a cell whose BAMs
    are decoded whole, or a program without the stream's counters),
    passes that disagree with the spans, or a program without the
    recorder: nothing to read, and nothing raised."""
    S = 10 ** 9

    def sp(name, run, s, e, thread="MainThread", counts=None):
        return types.SimpleNamespace(
            name=name, id=hash((name, run, s)), parent=0, run=run,
            thread=thread, start_ns=int(s * S), end_ns=int(e * S), items=0,
            counts=counts)

    whole = [sp("phaser main", 1, 0, 10), sp("#2 bam decode", 1, 1, 2)]
    monkeypatch.setattr(_spans, "recorded", lambda: whole)
    for read in (decode_s, wait_s, blocked_s):
        assert read({"spans": [(0.0, 10.0)]}) is None
    # another run's stream is not this window's; windows without the
    # stream's counters are a program that lacks them
    n = {"reads": 5, "bytes_in": 9, "bytes_out": 20}
    other = whole + [sp("decode window", 2, 1, 3, "phaser-tpu-prefetch", n),
                     sp("decode window", 1, 1, 3, "phaser-tpu-prefetch")]
    monkeypatch.setattr(_spans, "recorded", lambda: other)
    for read in (decode_s, wait_s, blocked_s):
        assert read({"spans": [(0.0, 10.0)]}) is None
    streamed = whole + [
        sp("decode window", 1, 1, 3, "phaser-tpu-prefetch", n),
        sp("decode window", 1, 3, 4, "phaser-tpu-prefetch", n),
        sp("#2 bam decode", 1, 3, 3.5, counts={"stream_waits": 1})]
    monkeypatch.setattr(_spans, "recorded", lambda: streamed)
    ctx = {"spans": [(0.0, 10.0)]}
    assert decode_s(ctx) == pytest.approx(3.0)
    assert wait_s(ctx) == pytest.approx(0.5)
    assert blocked_s(ctx) == 0.0
    for read in (decode_s, wait_s, blocked_s):
        assert read({"spans": [(0.0, 10.0), (11.0, 12.0)]}) is None
        assert read({"spans": []}) is None
    fake = types.ModuleType("phaser_tpu_torch.utils.trace")
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "phaser_tpu_torch.utils.trace", fake)
    for read in (decode_s, wait_s, blocked_s):
        assert read({"spans": [(0.0, 1.0)]}) is None
