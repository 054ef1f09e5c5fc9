"""The harness end to end on the CPU: a run of each small cell with the
port's `--device cpu` route, and the same run picking up a configuration,
a traffic mix and a metric dropped in as new files."""

from __future__ import annotations

from conftest import Args, load_run

CELLS = ("small_rna.small_tissue", "small_dna.small_wgs30x")


def test_small_cells_run_correct(checkout):
    run = load_run(checkout)
    for cell in CELLS:
        res = run.run(Args(cell), device="cpu", require_card=False,
                      root=str(checkout))
        assert res["correct"], res["checks"]
        assert res["attempted"] >= 1 and res["failed"] == 0
        assert set(res["metrics"]) == {"reads_per_s", "peak_rss_gb",
                                       "setup_s"}
        assert list(res)[-1] == "checks"


def test_per_layer_metrics_of_a_cpu_run(checkout):
    """With a trace the run prints the per-layer metrics; the stage readers
    read the CPU run, the device readers find nothing there."""
    run = load_run(checkout)
    res = run.run(Args(CELLS[1], trace=1), device="cpu", require_card=False,
                  root=str(checkout))
    assert res["correct"]
    m = res["metrics"]
    assert {"startup_s", "inputs_s", "vcf_s", "decode_s", "assign_s",
            "graph_s", "output_s", "unspanned_s"} <= set(m)
    assert "device_idle" not in m and "ragged_join_roofline" not in m
    assert m["decode_s"]["value"] > 0 and m["decode_s"]["unit"] == "s/pass"
