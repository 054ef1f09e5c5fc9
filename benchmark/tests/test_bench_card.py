"""On the card: a small cell through the harness's own path, `--device
cuda` and the profiler's trace, comes out correct and reads its device
metrics."""

from __future__ import annotations

import pytest

from conftest import Args, load_run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_small_cell_on_the_card(card, checkout):
    run = load_run(checkout)
    res = run.run(Args("small_dna.small_wgs30x", trace=1),
                  root=str(checkout))
    assert res["correct"], res["checks"]
    assert 0 < res["metrics"]["device_idle"]["value"] < 100
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["ragged_join_roofline"]["value"] <= 100
