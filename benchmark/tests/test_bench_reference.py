"""The plain reference against the port's `--device cpu` outputs on small
inputs shaped like each cell's, and the lower-precision control that the
comparison must refuse."""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import pytest

from conftest import small_config
from gen import make
from reference import pipeline
from reference.compare import compare

SEED = 2 ** 31 + 99


def _port_run(cfg, d, man, device="cpu"):
    from phaser_tpu_torch.cli import phaser_main
    argv = (["--bam", ",".join(os.path.join(d, b) for b in man["bams"]),
             "--vcf", os.path.join(d, man["vcf"]), "--sample", cfg["sample"]]
            + cfg["flags"] + ["--device", device, "--o", d + "/port"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert phaser_main.main(argv) == 0
    return d + "/port"


@pytest.fixture(scope="module", params=[("gtex_rna", 0.03),
                                        ("dna_rna_1kg", 0.04)],
                ids=["gtex_rna", "dna_rna_1kg"])
def case(request, tmp_path_factory):
    name, scale = request.param
    cfg, mix = small_config(name, scale)
    d = str(tmp_path_factory.mktemp(name))
    man = make.make(cfg, mix, SEED, d, threads=2)
    donor, sets = make.inputs(cfg, mix, SEED)
    return cfg, d, man, donor, sets


def test_reference_equals_the_port_on_the_cpu(case):
    cfg, d, man, donor, sets = case
    port = _port_run(cfg, d, man)
    pipeline.run(cfg, donor, sets, d + "/ref")
    res = compare(port, d + "/ref")
    assert res == {"rows_differ": 0, "real_gap": 0.0, "files_missing": 0}
    # the comparison has something to compare
    assert os.path.getsize(port + ".allelic_counts.txt") > 1000


def test_float32_control_fails_the_limit(case):
    cfg, d, man, donor, sets = case
    pipeline.run(cfg, donor, sets, d + "/ref64")
    pipeline.run(cfg, donor, sets, d + "/ref32", p_dtype=np.float32)
    res = compare(d + "/ref32", d + "/ref64", got_vcf=".vcf")
    assert res["files_missing"] == 0
    limits = cfg["limits"]
    if cfg["sample"] == "NA06986":
        # the DNA pairs test conflicting configurations: p-values to round
        assert res["real_gap"] > limits["real_gap"]
    assert res["rows_differ"] <= limits["rows_differ"] or \
        res["real_gap"] > limits["real_gap"]


def test_control_script_comes_out_not_correct(checkout):
    """benchmark/control.py on a small DNA cell: the float32 control fails
    the configuration's limits, with every output compared."""
    import importlib.util
    from harness.cell import load
    spec = importlib.util.spec_from_file_location(
        "bench_control", str(checkout / "benchmark" / "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    cell = load(str(checkout), str(checkout / "benchmark"),
                "small_dna.small_wgs30x")
    r = control.readings(cell, SEED)
    assert r["correct"] is False and r["files_missing"] == 0
    assert r["real_gap"] > cell.config["limits"]["real_gap"]
