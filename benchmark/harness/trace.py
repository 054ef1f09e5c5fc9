"""The device trace of the window: torch.profiler with CUDA activity only,
written as a Chrome trace and reduced to the seconds the card was busy,
the time of each device operation and the idle gaps between them."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self, path: str) -> List[dict]:
        """Stops the profiler; the device operations it saw, by start."""
        self._torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(path)
        return device_events(path)


def device_events(path: str) -> List[dict]:
    with open(path) as fh:
        data = json.load(fh)
    ev = [e for e in data.get("traceEvents", [])
          if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ev.sort(key=lambda e: float(e["ts"]))
    return ev


def busy_seconds(events: List[dict]) -> float:
    """Seconds in which some operation ran: the union of their spans."""
    total, end = 0.0, None
    for e in events:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total / 1e6


def op_seconds(events: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + float(e.get("dur", 0)) / 1e6
    return out


def idle_gaps(events: List[dict], n_passes: int) -> List[Tuple[str, float]]:
    """Gaps between device operations, each named by the pass it falls in
    (every pass enqueues the same operations) and the operation after it."""
    per = len(events) // n_passes if n_passes and \
        len(events) % n_passes == 0 else 0
    gaps = []
    end = None
    for i, e in enumerate(events):
        s = float(e["ts"])
        if end is not None and s > end:
            where = "pass_%d" % (i // per) if per else "window"
            gaps.append(("%s before %s" % (where, e["name"][:48]),
                         (s - end) / 1e6))
        end = max(end or 0.0, s + float(e.get("dur", 0.0)))
    return gaps


def breakdown(events: List[dict], n_passes: int) -> dict:
    ops = sorted(op_seconds(events).items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(events, n_passes), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
