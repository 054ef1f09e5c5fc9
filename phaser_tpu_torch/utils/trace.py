"""Stage tracing: wall-clock timers, throughput counters, peak RSS, spans
on the profiler's clock, and the PHASER_TPU_PROFILE_DIR trace.

The reference's observability is stage prints + a per-100k-reads progress
line + peak RSS (reference phaser/phaser.py:161-175, 2354-2356,
read_variant_map.py:120-123).  This module structures the same signals:
every pipeline stage records wall time and item counts; a run summary
reports reads/s per stage.

Spans.  While a torch profiler is active on the calling thread (or the
PHASER_TPU_PROFILE_DIR trace owns the run), every `span` and every
`Tracer.stage` is also recorded: name, start and end on
`time.perf_counter_ns()`, its parent span, the run it belongs to (a span
opened with no span around it starts a run, and records one anchor pair
`(perf_counter_ns, time_ns)` that maps the run's spans onto the unix clock,
and through a Chrome trace's `baseTimeNanoseconds` onto the device trace),
its thread, its items and its counters.  Spans go to a bounded buffer
(`recorded_spans`, `clear_spans`).  The profiler's state is thread-local,
so a thread working for a span is handed it (`carry`, `under`).  With no
profiler a span costs one check and makes nothing.

PHASER_TPU_PROFILE_DIR: a run writes one Chrome trace there, holding the
card's own activity (torch.profiler, CUDA only) and the run's spans as host
events, a track a thread; without a card, the spans alone.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import resource
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from torch._C._autograd import _profiler_enabled as _profiler_on

# process-wide device-path time: the card's own seconds (DeviceClock: CUDA
# events around uploads, kernels and fetches) of mapper.dispatch and of the
# device paths of engine.connections, engine.blocks and engine.phasing;
# host-clock seconds of the same work on the CPU. Tracer snapshots this
# around a run so the summary can state what fraction of wall-clock the
# device path actually consumed under --device cuda, so a claim that the
# card carries the run stays falsifiable.
_DEVICE_SECONDS = 0.0
_DEVICE_LOCK = threading.Lock()
_tls = threading.local()
# one PHASER_TPU_PROFILE_DIR trace per process: profilers do not nest, so
# of concurrent runs (shard threads) only the first writes one
_PROFILE_LOCK = threading.Lock()
_profile_owner = None
PROFILE_DIR_ENV = "PHASER_TPU_PROFILE_DIR"


def add_device_time(seconds: float) -> None:
    global _DEVICE_SECONDS
    with _DEVICE_LOCK:
        _DEVICE_SECONDS += seconds
    _tls.seconds = getattr(_tls, "seconds", 0.0) + seconds


def device_seconds() -> float:
    return _DEVICE_SECONDS


def thread_device_seconds() -> float:
    """Device-path seconds accumulated by THIS thread — the per-shard
    number when shard engines run on threads (each engine's device
    launch/wait/fetch all happen on its own thread under --device auto)."""
    return getattr(_tls, "seconds", 0.0)


# ---------------------------------------------------------------------------
# spans

SPAN_LIMIT = 1 << 16        # spans kept; later ones are counted as dropped
_SPANS: List["Span"] = []
_SPAN_LOCK = threading.Lock()
_dropped = 0
_span_ids = itertools.count(1)
_run_ids = itertools.count(1)
# run id -> (perf_counter_ns, time_ns) read together when the run started
_ANCHORS: Dict[int, Tuple[int, int]] = {}
_NO_SPAN = contextlib.nullcontext()


class Span:
    """One recorded span: times on time.perf_counter_ns(); `parent` is the
    id of the span around it (0 for a run's first span); `counts` the
    increase of the span's counters inside it."""

    __slots__ = ("name", "id", "parent", "run", "thread", "start_ns",
                 "end_ns", "items", "counts")

    def __init__(self, name: str, parent: Optional["Span"]):
        self.name = name
        self.id = next(_span_ids)
        self.parent = parent.id if parent is not None else 0
        self.run = parent.run if parent is not None else next(_run_ids)
        self.thread = threading.current_thread().name
        self.start_ns = self.end_ns = 0
        self.items = 0
        self.counts: Optional[Dict[str, int]] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return "Span(%r, id=%d, parent=%d, run=%d, %s, %.6fs)" % (
            self.name, self.id, self.parent, self.run, self.thread,
            self.seconds)


class _Recording:
    """The context of one recorded span."""

    __slots__ = ("span", "_parent", "_counters", "_c0")

    def __init__(self, name: str, parent: Optional[Span],
                 counters: Optional[Callable[[], Dict[str, int]]]):
        self.span = Span(name, parent)
        self._parent = parent
        self._counters = counters

    def __enter__(self) -> Span:
        sp = self.span
        if self._counters is not None:
            self._c0 = self._counters()
        _tls.span = sp
        sp.start_ns = time.perf_counter_ns()
        if self._parent is None:
            _ANCHORS[sp.run] = (sp.start_ns, time.time_ns())
        return sp

    def __exit__(self, *exc) -> bool:
        global _dropped
        sp = self.span
        sp.end_ns = time.perf_counter_ns()
        _tls.span = self._parent
        if self._counters is not None:
            c1 = self._counters()
            sp.counts = {k: v - self._c0.get(k, 0) for k, v in c1.items()}
        with _SPAN_LOCK:
            if len(_SPANS) < SPAN_LIMIT:
                _SPANS.append(sp)
            else:
                _dropped += 1
        return False


def span(name: str, counters: Optional[Callable[[], Dict[str, int]]] = None):
    """A context that records a span named `name` while a profiler is
    active on this thread, a span is open around it, or the
    PHASER_TPU_PROFILE_DIR trace runs; it gives the Span, else None.
    `counters`, a function returning a dict of counts, is read as the span
    opens and closes.  Not recording costs this one check."""
    parent = getattr(_tls, "span", None)
    if parent is None and _profile_owner is None and not _profiler_on():
        return _NO_SPAN
    return _Recording(name, parent, counters)


def root_span(name: str):
    """`span` for a run's outermost span: opened with no span around it, no
    profiler active and PHASER_TPU_PROFILE_DIR set, it also takes the
    process's one trace there, written when it closes."""
    prof_dir = os.environ.get(PROFILE_DIR_ENV)
    if prof_dir and getattr(_tls, "span", None) is None and \
            _profile_owner is None and not _profiler_on():
        return _exported(name, prof_dir)
    return span(name)


@contextlib.contextmanager
def _exported(name: str, prof_dir: str):
    export = _Export.start(prof_dir)
    try:
        with span(name) as sp:
            yield sp
    finally:
        if export is not None:
            export.finish()


def current_span() -> Optional[Span]:
    """The span open on this thread (None when nothing records)."""
    return getattr(_tls, "span", None)


@contextlib.contextmanager
def under(parent: Optional[Span]):
    """Spans opened inside hang under `parent`: how a thread working for a
    span (which the profiler's thread-local state does not reach) records."""
    prev = getattr(_tls, "span", None)
    _tls.span = parent
    try:
        yield
    finally:
        _tls.span = prev


def carry(fn: Callable) -> Callable:
    """fn, running under the caller's current span on whatever thread calls
    it; fn itself when no span is open."""
    parent = getattr(_tls, "span", None)
    if parent is None:
        return fn

    def carried(*args, **kw):
        with under(parent):
            return fn(*args, **kw)
    return carried


def recorded_spans() -> List[Span]:
    """The spans recorded so far, in the order they closed."""
    with _SPAN_LOCK:
        return list(_SPANS)


def dropped_spans() -> int:
    """Spans not kept since the buffer filled (SPAN_LIMIT)."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _SPAN_LOCK:
        _SPANS.clear()
        _dropped = 0


def unix_interval(sp: Span) -> Tuple[int, int]:
    """(start, end) of a span in unix nanoseconds, through its run's
    anchor."""
    perf0, unix0 = _ANCHORS[sp.run]
    return unix0 + sp.start_ns - perf0, unix0 + sp.end_ns - perf0


def _chrome_events(spans: List[Span], base_ns: int) -> List[dict]:
    """The spans as Chrome trace events on an axis that starts at unix
    `base_ns` (a torch.profiler trace's `baseTimeNanoseconds`): a complete
    event a span, on a track for each thread of this process."""
    pid = os.getpid()
    tids: Dict[str, int] = {}
    out = []
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        s, e = unix_interval(sp)
        args = {"id": sp.id, "parent": sp.parent, "run": sp.run}
        if sp.items:
            args["items"] = sp.items
        if sp.counts:
            args.update(sp.counts)
        out.append({"ph": "X", "cat": "phaser_span", "name": sp.name,
                    "pid": pid, "tid": tid, "ts": (s - base_ns) / 1e3,
                    "dur": (e - s) / 1e3, "args": args})
    out.append({"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": "phaser host spans"}})
    for name, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    return out


class _Export:
    """The PHASER_TPU_PROFILE_DIR trace of one run: torch.profiler with
    CUDA activity only when there is a card, and the spans recorded while
    it runs, added to the profiler's Chrome trace on its own axis."""

    def __init__(self, prof_dir: str):
        self.path = os.path.join(prof_dir, "phaser_trace_%d_%d.json"
                                 % (os.getpid(), time.time_ns()))
        self.first_id = next(_span_ids)
        self.profiler = None

    @classmethod
    def start(cls, prof_dir: str) -> Optional["_Export"]:
        """The process's one trace, or None when another run holds it."""
        global _profile_owner
        with _PROFILE_LOCK:
            if _profile_owner is not None:
                return None
            try:
                os.makedirs(prof_dir, exist_ok=True)
            except OSError:
                return None
            export = _profile_owner = cls(prof_dir)
        import torch
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile
            try:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                export.profiler = prof
            except Exception:  # noqa: BLE001 - the spans alone, then
                export.profiler = None
        return export

    def finish(self) -> None:
        global _profile_owner
        try:
            data = {"schemaVersion": 1, "traceEvents": []}
            if self.profiler is not None:
                import torch
                torch.cuda.synchronize()
                self.profiler.stop()
                self.profiler.export_chrome_trace(self.path)
                with open(self.path) as fh:
                    data = json.load(fh)
            spans = [sp for sp in recorded_spans() if sp.id > self.first_id]
            base = data.get("baseTimeNanoseconds")
            if base is None:
                first = min((unix_interval(sp)[0] for sp in spans),
                            default=time.time_ns())
                base = data["baseTimeNanoseconds"] = first // 10**9 * 10**9
            data.setdefault("traceEvents", []).extend(
                _chrome_events(spans, base))
            with open(self.path, "w") as fh:
                json.dump(data, fh)
        except Exception:  # noqa: BLE001 - tracing never fails a run
            pass
        finally:
            with _PROFILE_LOCK:
                _profile_owner = None


class DeviceClock:
    """Device seconds of the work a caller enqueues on one device.

    On a CUDA device `span()` brackets what is enqueued inside it with two
    CUDA events on the current stream, and `collect()` sums the events'
    elapsed times once the work has finished: the card's own clock, which
    host-side packing between two spans does not reach.  (The host time
    between a span's first and last enqueue, some microseconds, is inside
    it when the stream is idle.)  On the CPU, where the "device" work runs
    inside the call, a span is host-clock time."""

    def __init__(self, dev):
        self._dev = dev
        self._cuda = dev.type == "cuda"
        self._pairs = []
        self._host = 0.0

    @contextlib.contextmanager
    def span(self):
        if not self._cuda:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host += time.perf_counter() - t0
            return
        import torch
        stream = torch.cuda.current_stream(self._dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            self._pairs.append((start, end))

    def collect(self) -> float:
        """Seconds of the spans since the last collect (waits for their
        work to finish), also added to the process and thread totals."""
        pairs, self._pairs = self._pairs, []
        seconds, self._host = self._host, 0.0
        for start, end in pairs:
            end.synchronize()
            seconds += start.elapsed_time(end) / 1e3
        add_device_time(seconds)
        return seconds


# torch.profiler windows: how many a measurement may take to come back whole,
# and the runtime calls that enqueue work on the card, as the profiler names
# them
PROFILE_TRIES = 5
RUNTIME_ENQUEUES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                    "cuLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync")


def profile_window(fn, iters: int):
    """(key averages of `iters` calls of fn, device records, runtime
    enqueues) from one torch.profiler window of CPU and CUDA activities.
    Late in a long process a window has come back short of its first two
    dozen device records, so the calls are profiled as the active step of
    a schedule whose warm-up step (the same calls, traced and discarded)
    takes that loss; the window is whole when the two counts agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # the schedule's own step marker is a device record too: not the calls'
    avgs = [e for e in prof.key_averages()
            if not e.key.startswith("ProfilerStep")]
    device = sum(e.count for e in avgs if e.device_type == DeviceType.CUDA)
    runtime = sum(e.count for e in avgs if e.device_type != DeviceType.CUDA
                  and e.key.startswith(RUNTIME_ENQUEUES))
    return avgs, device, runtime


def device_activity(fn, iters: int = 20, tries: int = PROFILE_TRIES,
                    log=None):
    """(card ms, device activities, whole) a call of fn from torch.profiler:
    the device time of every kernel, fill and copy it enqueues, summed, and
    their count, from the first whole window of `tries` (profile_window);
    after them the last window that saw any activity, with whole False;
    None when none did.  `log` receives a line for each window that is not
    whole."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(tries):
        avgs, device, runtime = profile_window(fn, iters)
        if device:
            us = sum(e.device_time_total for e in avgs
                     if e.device_type == DeviceType.CUDA)
            seen = (us / iters / 1e3, device / iters, device == runtime)
            if seen[2]:
                return seen
        if log is not None:
            log("profile not whole (%d device records, %d runtime enqueues)"
                % (device, runtime))
    return seen


@dataclass
class StageStat:
    name: str
    seconds: float = 0.0
    items: int = 0
    unit: str = "items"

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class Tracer:
    stats: Dict[str, StageStat] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    _last: Dict[str, Span] = field(default_factory=dict)
    _t0: float = 0.0
    _dev0: float = 0.0

    def __post_init__(self):
        self._t0 = time.perf_counter()
        self._dev0 = thread_device_seconds()

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items",
              counters: Optional[Callable[[], Dict[str, int]]] = None):
        """Times the work inside as stage `name` and records it as a span
        (`span`), with the increase of `counters` inside it."""
        from .failures import failure_stage
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        st = self.stats[name]
        t0 = time.perf_counter()
        try:
            with span(name, counters) as sp, failure_stage(name):
                if sp is not None:
                    self._last[name] = sp
                yield st
        finally:
            st.seconds += time.perf_counter() - t0

    def span(self, name: str,
             counters: Optional[Callable[[], Dict[str, int]]] = None):
        """An unnumbered span: recorded as a stage is, never timed into
        the stage table."""
        return span(name, counters)

    def add(self, name: str, items: int, unit: str = "items") -> None:
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        self.stats[name].items += items
        sp = self._last.get(name)
        if sp is not None:
            sp.items += items

    def peak_rss_mb(self) -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    def device_share(self) -> tuple:
        """(device_path_seconds, wall_seconds) since this tracer started —
        device seconds are THREAD-scoped, so concurrent shard engines each
        report only their own device time."""
        return (thread_device_seconds() - self._dev0,
                time.perf_counter() - self._t0)

    def summary_lines(self) -> List[str]:
        out = ["     --- stage timings ---"]
        for name in self.order:
            st = self.stats[name]
            line = "     %-28s %8.3fs" % (name, st.seconds)
            if st.items:
                line += "  %12d %s (%.0f/s)" % (st.items, st.unit, st.rate)
            out.append(line)
        dev, wall = self.device_share()
        out.append("     device path: %.3fs of %.3fs wall (%.1f%%)"
                   % (dev, wall, 100.0 * dev / wall if wall > 0 else 0.0))
        out.append("     peak RSS: %.1f MB" % self.peak_rss_mb())
        return out
