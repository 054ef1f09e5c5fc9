"""Stage tracing: wall-clock timers, throughput counters, peak RSS, and
optional torch.profiler capture.

The reference's observability is stage prints + a per-100k-reads progress
line + peak RSS (reference phaser/phaser.py:161-175, 2354-2356,
read_variant_map.py:120-123).  This module structures the same signals:
every pipeline stage records wall time and item counts; a run summary
reports reads/s per stage.  Set PHASER_TPU_PROFILE_DIR to also capture a
torch.profiler trace (CPU and, with a card, CUDA activities) of the run,
written to that directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import resource
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
# one torch.profiler capture per process: profilers do not nest, so of
# concurrent shard-engine tracers only the first captures
_PROFILE_LOCK = threading.Lock()
_profile_owner = None


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


@contextlib.contextmanager
def device_section():
    """Host-clock seconds of the work inside, added to the device-path
    totals (phaser_tpu's measure; the port's stages use DeviceClock)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_device_time(time.perf_counter() - t0)


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
    _profiler: object = None
    _profile_path: str = ""
    _t0: float = 0.0
    _dev0: float = 0.0

    def __post_init__(self):
        self._t0 = time.perf_counter()
        self._dev0 = thread_device_seconds()
        prof_dir = os.environ.get("PHASER_TPU_PROFILE_DIR")
        if prof_dir:
            self._start_profile(prof_dir)

    def _start_profile(self, prof_dir: str) -> None:
        global _profile_owner
        with _PROFILE_LOCK:
            if _profile_owner is not None:
                return
            _profile_owner = self
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(prof_dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
            self._profiler = prof
            self._profile_path = os.path.join(
                prof_dir, "phaser_trace_%d_%d.json"
                % (os.getpid(), time.time_ns()))
        except Exception:
            with _PROFILE_LOCK:
                _profile_owner = None

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        from .failures import failure_stage
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        st = self.stats[name]
        t0 = time.perf_counter()
        try:
            with failure_stage(name):
                yield st
        finally:
            st.seconds += time.perf_counter() - t0

    def add(self, name: str, items: int, unit: str = "items") -> None:
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        self.stats[name].items += items

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

    def finish(self) -> None:
        global _profile_owner
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        try:
            prof.stop()
            prof.export_chrome_trace(self._profile_path)
        except Exception:
            pass
        finally:
            with _PROFILE_LOCK:
                _profile_owner = None
