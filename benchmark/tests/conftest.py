"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout whose BENCHMARK.json holds small cells shaped like the
real ones, the port linked in beside it."""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


def small_config(name: str, scale: float) -> tuple:
    """(config, traffic) of a real cell cut to `scale` of its region,
    lines and reads."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    w = {x["config"]: x for x in spec["workloads"]}[name]
    cfg = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    mix = json.load(open(os.path.join(BENCH, "traffic",
                                      w["traffic"] + ".json")))
    r0, r1 = cfg["region"]
    cfg["region"] = [r0, r0 + int((r1 - r0) * scale)]
    cfg["vcf"]["lines"] = int(cfg["vcf"]["lines"] * scale)
    for b in mix["bams"].values():
        b["reads"] = int(b["reads"] * scale) // 2 * 2
        if "genes" in b:
            b["genes"] = max(4, int(b["genes"] * scale))
            b["max_gene_share"] = max(b["max_gene_share"], 2.0 / b["genes"])
    return cfg, mix


@pytest.fixture
def checkout(tmp_path):
    """A checkout holding BENCHMARK.json, a copy of benchmark/ with two
    small cells (`small_rna.small_tissue`, `small_dna.small_wgs30x`) and the
    port."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "phaser_tpu_torch"),
               root / "phaser_tpu_torch")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec = copy.deepcopy(spec)
    for real, small, traffic, scale in (
            ("gtex_rna", "small_rna", "small_tissue", 0.02),
            ("dna_rna_1kg", "small_dna", "small_wgs30x", 0.03)):
        cfg, mix = small_config(real, scale)
        (root / "benchmark" / "configs" / (small + ".json")).write_text(
            json.dumps(cfg))
        (root / "benchmark" / "traffic" / (traffic + ".json")).write_text(
            json.dumps(mix))
        spec["configs"].append(
            {"name": small, "source": "test", "file":
             "benchmark/configs/%s.json" % small, "reduced": [], "why": "t"})
        cell = "%s.%s" % (small, traffic)
        spec["workloads"].append({"name": cell, "config": small,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        for m in spec["per_layer"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def load_run(root):
    """benchmark/run.py of the checkout at root, as a module."""
    path = os.path.join(str(root), "benchmark", "run.py")
    spec = importlib.util.spec_from_file_location("bench_run_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Args:
    def __init__(self, workload, seed=2 ** 31 + 7, seconds=0.5, trace=0):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace
