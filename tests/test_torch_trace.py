"""phaser_tpu_torch's span recorder (utils/trace.py): spans recorded only
while a profiler runs, their parents, runs and threads, the tree of spans
a run of the CLI leaves (disjoint children of `phaser run` that cover the
pass), the streaming decode's windows on the prefetch thread, and the
anchor that maps a span onto a profiler trace's clock."""

import contextlib
import importlib.util
import io
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from phaser_tpu_torch.cli import phaser_main
from phaser_tpu_torch.testing import datagen
from phaser_tpu_torch.utils import trace
from phaser_tpu_torch.utils.trace import Tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["#1 vcf filter", "#2 bam decode", "#2 allele assignment",
          "#2 hit resolve", "#2 accumulate", "#3 connections",
          "#4/#5 blocks+phasing", "#6 outputs", "#7 vcf write"]
GLUE = {"input sizes", "prefault start", "vcf header", "variant tables",
        "decode plan", "read filter", "as cutoffs", "entry offsets", "noise",
        "tables write", "rsid lookup", "release", "summary"}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("PHASER_TPU_PROFILE_DIR", raising=False)
    trace.clear_spans()
    yield
    trace.clear_spans()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace_fixture"))
    vcf, bam, data = datagen.write_fixture_dir(
        d, seed=51, contigs=("chr20", "chr21"), contig_len=20000,
        n_variants_per_contig=100, n_reads_per_contig=1500)
    return d, vcf, bam, data.sample


def _argv(fixture_files, out):
    d, vcf, bam, sample = fixture_files
    return ["--vcf", vcf, "--bam", bam + "," + bam, "--sample", sample,
            "--mapq", "10", "--baseq", "10", "--paired_end", "1",
            "--device", "cpu", "--o", out]


def _traced_cli_run(fixture_files, out):
    """(stdout, spans, pass wall (start, end) on perf_counter_ns) of one CLI
    run under a CPU profiler."""
    buf = io.StringIO()
    with _cpu_profiler(), contextlib.redirect_stdout(buf):
        t0 = time.perf_counter_ns()
        assert phaser_main.main(_argv(fixture_files, out)) == 0
        t1 = time.perf_counter_ns()
    return buf.getvalue(), trace.recorded_spans(), (t0, t1)


def _stages_parser():
    path = os.path.join(REPO, "benchmark", "harness", "stages.py")
    spec = importlib.util.spec_from_file_location("bench_stages", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_span_parents_runs_and_threads():
    """A span opened with no span around it starts a run; spans inside hang
    under it; a thread handed the span by `carry` records under it with
    its own thread name; the next outermost span starts another run."""
    with _cpu_profiler():
        with trace.span("outer") as outer:
            with trace.span("inner") as inner:
                pass
            with ThreadPoolExecutor(1, thread_name_prefix="worker") as ex:
                ex.submit(trace.carry(_open_close), "in thread").result()
            t = threading.Thread(target=trace.carry(_open_close),
                                 args=("in plain thread",), name="plain")
            t.start()
            t.join()
        with trace.span("second") as second:
            pass
    spans = {s.name: s for s in trace.recorded_spans()}
    assert set(spans) == {"outer", "inner", "in thread", "in plain thread",
                          "second"}
    assert outer.parent == 0 and second.parent == 0
    assert inner.parent == outer.id and inner.run == outer.run
    for name, thread in (("in thread", "worker"),
                         ("in plain thread", "plain")):
        sp = spans[name]
        assert sp.parent == outer.id and sp.run == outer.run
        assert sp.thread.startswith(thread)
    assert outer.thread == threading.current_thread().name
    assert second.run != outer.run
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # a run's anchor maps its spans onto the unix clock
    s, e = trace.unix_interval(outer)
    assert e - s == outer.end_ns - outer.start_ns
    assert abs(s - time.time_ns()) < 60 * 10**9


def _open_close(name):
    with trace.span(name):
        pass


def test_a_thread_not_handed_the_span_records_nothing():
    """The profiler's state is thread-local: a plain thread records only
    under a span it is handed."""
    with _cpu_profiler():
        with trace.span("outer"):
            t = threading.Thread(target=_open_close, args=("lost",))
            t.start()
            t.join()
    assert [s.name for s in trace.recorded_spans()] == ["outer"]


def test_nothing_is_recorded_or_made_without_a_profiler(monkeypatch):
    """No profiler: span, Tracer.stage and carry make no Span (the class is
    never called) and record nothing; every span is the one shared no-op
    context."""
    made = []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(trace, "Span", Counted)
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b")
    tr = Tracer()
    with trace.span("a") as sp:
        assert sp is None and trace.current_span() is None
        with tr.stage("#1 x", "lines") as st:
            pass
        with tr.span("glue") as g:
            assert g is None
    tr.add("#1 x", 5, "lines")
    fn = lambda: 1  # noqa: E731
    assert trace.carry(fn) is fn
    assert st.items == 5 and st.seconds > 0
    assert made == [] and trace.recorded_spans() == []
    # under a profiler the same code makes and keeps them
    with _cpu_profiler():
        with tr.stage("#1 x", "lines"):
            pass
    assert len(made) == 1 and len(trace.recorded_spans()) == 1


def test_stage_span_carries_items_and_counters():
    """Tracer.add lands on the stage's span; the counters' increase inside
    the span is its `counts`."""
    box = {"n": 3, "m": 10}
    tr = Tracer()
    with _cpu_profiler():
        with tr.stage("#2 x", "reads", lambda: dict(box)):
            box["n"] += 4
        tr.add("#2 x", 7, "reads")
    sp, = trace.recorded_spans()
    assert sp.name == "#2 x" and sp.items == 7
    assert sp.counts == {"n": 4, "m": 0}
    assert tr.stats["#2 x"].seconds >= sp.seconds * 0.5


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "SPAN_LIMIT", 3)
    with _cpu_profiler():
        for i in range(5):
            _open_close("s%d" % i)
    assert [s.name for s in trace.recorded_spans()] == ["s0", "s1", "s2"]
    assert trace.dropped_spans() == 2
    trace.clear_spans()
    assert trace.recorded_spans() == [] and trace.dropped_spans() == 0


def test_cli_run_leaves_a_tree_that_covers_the_pass(fixture_files, tmp_path):
    """One CLI run under a CPU profiler: `phaser main` > `cli`, `phaser run`
    > the numbered stages and the glue spans; the children of `phaser run`
    are disjoint and cover nearly all of it; the stage table printed is
    the one the benchmark's parser reads, with the same stages as before,
    and the counters ride on `#2 allele assignment`."""
    out, spans, (t0, t1) = _traced_cli_run(fixture_files,
                                           str(tmp_path / "o"))
    main, = _by_name(spans, "phaser main")
    run, = _by_name(spans, "phaser run")
    assert main.parent == 0 and run.parent == main.id
    assert t0 <= main.start_ns and main.end_ns <= t1
    assert {s.run for s in spans} == {main.run}
    main_kids = sorted((s for s in spans if s.parent == main.id),
                       key=lambda s: s.start_ns)
    assert [s.name for s in main_kids] == ["cli", "phaser run", "cli"]
    kids = sorted((s for s in spans if s.parent == run.id),
                  key=lambda s: s.start_ns)
    names = {s.name for s in kids}
    assert GLUE <= names and set(STAGES) <= names
    assert names <= GLUE | set(STAGES)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    covered = sum(s.end_ns - s.start_ns for s in kids)
    assert covered >= 0.9 * (run.end_ns - run.start_ns)
    assert len(_by_name(spans, "decode plan")) == 2      # one a BAM
    parsed = _stages_parser()(out)
    assert list(parsed) == STAGES
    for name in STAGES:
        total = sum(s.seconds for s in _by_name(spans, name))
        assert abs(total - parsed[name]) < 2e-3 + 0.01 * parsed[name]
    assign = _by_name(spans, "#2 allele assignment")
    assert len(assign) == 2
    for sp in assign:
        assert sp.counts["rows_in"] >= sp.counts["rows_kept"] > 0
        assert {"uploads", "uploads_pinned",
                "launches_ragged_join"} <= set(sp.counts)
        assert sp.items > 0


def test_vcf_write_span_holds_the_writer_phases_and_line_counts(
        fixture_files, tmp_path):
    """`#7 vcf write` holds the native writer's six phases, in order, as
    its children; its counters say how many body lines the native emit
    wrote and how many phased ones Python formatted: together the body
    lines of the .vcf.gz."""
    from phaser_tpu_torch.io import bgzf
    out = str(tmp_path / "o")
    _, spans, _ = _traced_cli_run(fixture_files, out)
    stage, = _by_name(spans, "#7 vcf write")
    kids = sorted((s for s in spans if s.parent == stage.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == [
        "vcf inflate", "vcf scan", "vcf phased", "vcf emit", "vcf compress",
        "vcf index"]
    assert stage.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= stage.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    text = bgzf.decompress_all(open(out + ".vcf.gz", "rb").read()).decode()
    n_body = sum(not line.startswith("#") for line in text.splitlines())
    counts = stage.counts
    assert counts["lines_native"] > 0 and counts["lines_python"] > 0
    assert counts["lines_native"] + counts["lines_python"] == n_body


def test_streaming_decode_windows_on_the_prefetch_thread(
        fixture_files, tmp_path, monkeypatch):
    """Above the streaming threshold the windows decode on the prefetch
    thread, as `decode window` spans under `phaser run`; the main thread's
    `#2 bam decode` is the wait for them, more than 0 s."""
    monkeypatch.setenv("PHASER_TPU_STREAM_THRESHOLD_MB", "0")
    out, spans, _ = _traced_cli_run(fixture_files, str(tmp_path / "o"))
    assert "streaming decode" in out
    run, = _by_name(spans, "phaser run")
    windows = _by_name(spans, "decode window")
    assert len(windows) >= 2
    for w in windows:
        assert w.thread == "phaser-tpu-prefetch"
        assert w.parent == run.id and w.run == run.run
    waits = _by_name(spans, "#2 bam decode")
    assert waits and all(w.thread == run.thread for w in waits)
    assert sum(w.items for w in waits) == 12000
    assert _stages_parser()(out)["#2 bam decode"] > 0
    main_thread = sorted((s for s in spans if s.parent == run.id
                          and s.thread == run.thread),
                         key=lambda s: s.start_ns)
    for a, b in zip(main_thread, main_thread[1:]):
        assert a.end_ns <= b.start_ns, (a, b)


def test_a_record_function_inside_a_span_lands_inside_it(tmp_path):
    """The clock: a record_function range inside a span, from a CPU
    profiler's Chrome trace (ts + baseTimeNanoseconds), lies inside the
    span mapped to unix time through its run's anchor, within 1 ms."""
    path = str(tmp_path / "t.json")
    with _cpu_profiler() as prof:
        with trace.span("outer") as sp:
            time.sleep(0.002)
            with record_function("inside"):
                time.sleep(0.01)
            time.sleep(0.002)
    prof.export_chrome_trace(path)
    data = json.load(open(path))
    base = data["baseTimeNanoseconds"]
    ev, = [e for e in data["traceEvents"] if e.get("name") == "inside"]
    s = float(ev["ts"]) * 1e3 + base
    e = s + float(ev["dur"]) * 1e3
    lo, hi = trace.unix_interval(sp)
    assert lo - 1e6 <= s and e <= hi + 1e6
    assert e - s >= 9e6


def test_sharded_threads_hang_their_runs_under_the_caller(
        fixture_files, tmp_path):
    """--threads N on the card or the CPU: each shard thread's `phaser run`
    is a child of the span the caller opened, in the caller's run."""
    from phaser_tpu_torch.dist.engine_multihost import \
        run_phaser_sharded_threads
    d, vcf, bam, sample = fixture_files
    with _cpu_profiler(), contextlib.redirect_stdout(io.StringIO()):
        with trace.span("caller") as caller:
            run_phaser_sharded_threads(
                n_shards=2, vcf=vcf, bam=bam, sample=sample,
                o=str(tmp_path / "o"), mapq="10", baseq=10, paired_end="1",
                device="cpu", position_shards=True)
    runs = _by_name(trace.recorded_spans(), "phaser run")
    assert len(runs) == 2
    assert {r.parent for r in runs} == {caller.id}
    assert {r.run for r in runs} == {caller.run}
    assert len({r.thread for r in runs}) == 2
    assert caller.thread not in {r.thread for r in runs}


def test_profile_dir_writes_one_trace_a_run(fixture_files, tmp_path,
                                            monkeypatch):
    """PHASER_TPU_PROFILE_DIR with no card: each CLI run writes one Chrome
    trace holding its spans alone, a track a thread, on the axis its
    `baseTimeNanoseconds` starts; the run records nothing afterwards."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("PHASER_TPU_PROFILE_DIR", str(prof))
    if torch.cuda.is_available():
        pytest.skip("the card's trace is checked in tests/test_torch_gpu.py")
    for k in range(2):
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.time_ns()
            assert phaser_main.main(
                _argv(fixture_files, str(tmp_path / ("o%d" % k)))) == 0
            t1 = time.time_ns()
    files = sorted(os.listdir(str(prof)))
    assert len(files) == 2
    data = json.load(open(str(prof / files[-1])))
    base = data["baseTimeNanoseconds"]
    ev = data["traceEvents"]
    spans = [e for e in ev if e.get("ph") == "X"]
    assert all(e["cat"] == "phaser_span" for e in spans)
    names = [e["name"] for e in spans]
    assert names.count("phaser main") == 1 and names.count("phaser run") == 1
    assert set(STAGES) | GLUE <= set(names)
    main, = [e for e in spans if e["name"] == "phaser main"]
    assert t0 - 1e6 <= main["ts"] * 1e3 + base
    assert main["ts"] * 1e3 + base + main["dur"] * 1e3 <= t1 + 1e6
    tracks = {e["tid"]: e["args"]["name"] for e in ev
              if e.get("name") == "thread_name"}
    assert set(tracks.values()) == {threading.current_thread().name}
    assert not torch._C._autograd._profiler_enabled()
    assert trace.current_span() is None
    trace.clear_spans()
    _open_close("after")
    assert trace.recorded_spans() == []


def test_threads_recording_at_once_lose_no_span(monkeypatch):
    """More recording threads than cores, switching often: every span is
    kept or counted as dropped, none twice, each under its parent."""
    import sys
    n_threads, per = 4 * (os.cpu_count() or 2), 300
    monkeypatch.setattr(trace, "SPAN_LIMIT", n_threads * per // 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profiler():
            with trace.span("outer") as outer:
                work = trace.carry(lambda: [_open_close("s")
                                            for _ in range(per)])
                ts = [threading.Thread(target=work)
                      for _ in range(n_threads)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    kept = trace.recorded_spans()
    assert len(kept) == trace.SPAN_LIMIT
    assert len(kept) + trace.dropped_spans() == n_threads * per + 1
    assert len({s.id for s in kept}) == len(kept)
    assert all(s.parent == outer.id for s in kept)
