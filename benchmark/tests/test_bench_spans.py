"""The span readers (metrics/glue_s.py, untraced_s.py,
prefilter_kept_pct.py) on synthetic span lists, on a program without the
recorder, and on the port's own spans from passes of its CLI under a CPU
profiler."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import sys
import time
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
METRICS = os.path.join(BENCH, "metrics")
if METRICS not in sys.path:
    sys.path.insert(0, METRICS)

import _spans  # noqa: E402


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_test_" + name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


glue_s, untraced_s, prefilter_kept_pct = (
    _reader(n) for n in ("glue_s", "untraced_s", "prefilter_kept_pct"))
S = 10 ** 9


class Pass:
    """A synthetic pass of spans on one thread, times in seconds."""

    def __init__(self, run, t0, thread="MainThread"):
        self.run, self.thread, self.spans = run, thread, []
        self.main = self.add("phaser main", t0, t0 + 10, parent=0)
        self.root = self.add("phaser run", t0 + 1, t0 + 9,
                             parent=self.main.id)

    def add(self, name, s, e, parent=None, counts=None, thread=None):
        sp = types.SimpleNamespace(
            name=name, id=1000 * self.run + len(self.spans) + 1,
            parent=self.root.id if parent is None else parent,
            run=self.run, thread=thread or self.thread,
            start_ns=int(s * S), end_ns=int(e * S), items=0, counts=counts)
        self.spans.append(sp)
        return sp


def _two_passes():
    a, b = Pass(1, 100.0), Pass(2, 120.0)
    # pass a: cli 0.5 s and 0.5 s under main, glue 1 + 2 s, stages 3 s
    a.add("cli", 100.0, 100.5, parent=a.main.id)
    a.add("input sizes", 101.0, 102.0)
    a.add("#1 vcf filter", 102.0, 104.0)
    a.add("variant tables", 104.0, 106.0)
    a.add("#2 allele assignment", 106.0, 107.0,
          counts={"rows_in": 100, "rows_kept": 30})
    a.add("cli", 109.5, 110.0, parent=a.main.id)
    # a span under a glue span is not glue again; the window thread's
    # spans are another thread's
    a.add("inner", 104.5, 105.0, parent=a.spans[-3].id)
    a.add("decode window", 101.0, 108.0, thread="phaser-tpu-prefetch")
    # pass b: two stages overlapping each other, one glue span
    b.add("#2 bam decode", 121.0, 124.0)
    b.add("#2 allele assignment", 123.0, 125.0,
          counts={"rows_in": 300, "rows_kept": 10})
    b.add("tables write", 125.0, 126.5)
    return [a, b], [(99.9, 110.1), (119.8, 130.0)]


@pytest.fixture
def spans(monkeypatch):
    box = {"spans": None}
    monkeypatch.setattr(_spans, "recorded", lambda: box["spans"])
    return box


def test_glue_sums_unnumbered_children_of_the_roots(spans):
    ps, walls = _two_passes()
    spans["spans"] = [s for p in ps for s in p.spans]
    ctx = {"spans": walls}
    # a: cli 0.5 + 0.5, input sizes 1, variant tables 2 = 4; b: 1.5
    assert glue_s(ctx) == pytest.approx((4.0 + 1.5) / 2)


def test_untraced_is_the_wall_less_the_union_of_spans(spans):
    """Overlapping children count once; the window thread's spans do not
    cover the main thread; spans are clipped to the pass's wall."""
    ps, walls = _two_passes()
    spans["spans"] = [s for p in ps for s in p.spans]
    # a: wall 10.2; covered 100-100.5, 101-107, 109.5-110 = 7.0
    # b: wall 10.2; covered 121-126.5 = 5.5
    want = ((10.2 - 7.0) + (10.2 - 5.5)) / 2
    assert untraced_s({"spans": walls}) == pytest.approx(want)


def test_prefilter_share_sums_over_the_passes(spans):
    ps, walls = _two_passes()
    spans["spans"] = [s for p in ps for s in p.spans]
    assert prefilter_kept_pct({"spans": walls}) == pytest.approx(
        100.0 * 40 / 400)


def test_readers_give_nothing_when_passes_and_spans_disagree(spans):
    ps, walls = _two_passes()
    spans["spans"] = [s for p in ps for s in p.spans]
    for read in (glue_s, untraced_s, prefilter_kept_pct):
        assert read({"spans": walls[:1]}) is None
        assert read({"spans": walls + [(140.0, 150.0)]}) is None
        assert read({"spans": []}) is None
    spans["spans"] = []
    for read in (glue_s, untraced_s, prefilter_kept_pct):
        assert read({"spans": walls}) is None
    # no #2 span counted a row: no share
    p = Pass(3, 0.0)
    spans["spans"] = p.spans
    assert prefilter_kept_pct({"spans": [(0.0, 10.0)]}) is None
    assert glue_s({"spans": [(0.0, 10.0)]}) == 0.0


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    """The parent of the recorder: its trace module has no recorded_spans,
    and each reader returns None without raising."""
    fake = types.ModuleType("phaser_tpu_torch.utils.trace")
    monkeypatch.setitem(sys.modules, "phaser_tpu_torch.utils.trace", fake)
    for read in (glue_s, untraced_s, prefilter_kept_pct):
        assert read({"spans": [(0.0, 1.0)]}) is None


def test_readers_on_the_ports_own_passes(tmp_path, monkeypatch):
    """Two passes of the port's CLI under a CPU profiler, bounded as the
    window bounds them: glue and untraced add up to the pass less its
    numbered stages, untraced is a sliver, the pre-filter share is read."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from harness import stages
    from phaser_tpu_torch.cli import phaser_main
    from phaser_tpu_torch.testing import datagen
    from phaser_tpu_torch.utils import trace
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=51, contigs=("chr20",), contig_len=20000,
        n_variants_per_contig=100, n_reads_per_contig=1500)
    argv = ["--vcf", vcf, "--bam", bam, "--sample", data.sample, "--mapq",
            "10", "--baseq", "10", "--paired_end", "1", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        phaser_main.main(argv + ["--o", str(tmp_path / "warm")])
    trace.clear_spans()
    walls, parsed = [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(2):
            buf = io.StringIO()
            s = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                assert phaser_main.main(
                    argv + ["--o", str(tmp_path / ("p%d" % k))]) == 0
            walls.append((s, time.perf_counter()))
            parsed.append(stages.parse(buf.getvalue()))
    ctx = {"spans": walls}
    try:
        glue, blind = glue_s(ctx), untraced_s(ctx)
        kept = prefilter_kept_pct(ctx)
    finally:
        trace.clear_spans()
    unspanned = sum((e - s) - sum(p.values())
                    for (s, e), p in zip(walls, parsed)) / 2
    mean_wall = sum(e - s for s, e in walls) / 2
    assert glue > 0 and 0 <= blind < 0.05 * mean_wall
    assert glue + blind == pytest.approx(unspanned, abs=0.02 * mean_wall)
    assert 0 < kept <= 100
