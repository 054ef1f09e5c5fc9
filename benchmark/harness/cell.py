"""A cell as BENCHMARK.json and the files it names describe it: the
workload's entry, its configuration (`configs/<config>.json`), its traffic
mix (`traffic/<traffic>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`, each with `read(ctx)`)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List


@dataclass
class Cell:
    root: str            # the checkout
    bench: str           # the benchmark's folder
    spec: dict           # BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run of this cell prints: its end-to-end metrics,
        or with a trace its per-layer ones."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable[[dict], object]:
        folder = os.path.join(self.bench, "metrics")
        if folder not in sys.path:
            sys.path.insert(0, folder)
        path = os.path.join(folder, metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load(root: str, bench: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    wl = {w["name"]: w for w in spec["workloads"]}
    if workload not in wl:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    w = wl[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(root, bench, spec, w, config, traffic)


def read_metrics(cell: Cell, trace: bool, ctx: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose readers find
    something to read in ctx."""
    out = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
