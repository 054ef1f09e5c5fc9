"""A configuration, a traffic mix and a per-layer metric added as new
files and new BENCHMARK.json entries are picked up, with no file of the
benchmark edited."""

from __future__ import annotations

import hashlib
import json
import os

from conftest import Args, load_run


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_picked_up(checkout):
    bench = checkout / "benchmark"
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "small_dna.json").read_text())
    mix = json.loads((bench / "traffic" / "small_wgs30x.json").read_text())
    for b in mix["bams"].values():
        b["error_rate"] = 0.004
    (bench / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy_passes.py").write_text(
        "def read(ctx):\n    return float(len(ctx['spans']))\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "test",
                            "file": "benchmark/configs/dummy.json",
                            "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "t"})
    spec["per_layer"].append({"name": "dummy_passes", "unit": "passes",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "reads_per_s",
                              "workloads": ["dummy.dummy_mix"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    run = load_run(checkout)
    res = run.run(Args("dummy.dummy_mix", trace=1), device="cpu",
                  require_card=False, root=str(checkout))
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_passes"]["value"] == res["attempted"]
    # the other per-layer metrics list the cells they are read in
    assert set(res["metrics"]) == {"dummy_passes"}
    after = _digests(bench)
    changed = [k for k in before if before[k] != after.get(k)]
    assert changed == []
