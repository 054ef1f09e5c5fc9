"""The port's order-statistic bootstrap (phaser_tpu_torch.kernels.bootstrap,
torch code, run here on the CPU) against phaser_tpu's JAX program on the
CPU and against direct index resampling (the numpy engine's method).  The
streams differ (torch's generators are not JAX's PRNG), so the comparison
is of distributions: percentile estimates within |delta| < 0.1 at bs
20,000, the Monte-Carlo noise of a bootstrap median whose sd is about 0.2
(tests/test_bootstrap.py's model).  Within one device a seed gives the same
numbers on every call, whatever the chunking budget's free memory."""

import numpy as np
import pytest
import torch

from phaser_tpu.kernels.bootstrap import bootstrap_cis_device as jax_cis
from phaser_tpu_torch.kernels import bootstrap as B

SIZES = (41, 40, 7, 128)
BS = 20000


def _cohorts():
    rng = np.random.default_rng(5)
    return [rng.normal(size=n) for n in SIZES]


def _numpy_ci(x, bs, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(bs, len(x)))
    meds = np.median(np.asarray(x)[idx], axis=1)
    return (float(np.percentile(meds, 2.5)),
            float(np.percentile(meds, 97.5)),
            2 * min(int((meds > 0).sum()), int((meds < 0).sum())) / bs)


@pytest.fixture(scope="module")
def three_ways():
    cohorts = _cohorts()
    port = B.bootstrap_cis_device(cohorts, BS, seed=11, device="cpu")
    jax = jax_cis(cohorts, BS, seed=11)
    direct = [_numpy_ci(c, BS, seed=3) for c in cohorts]
    return port, jax, direct


@pytest.mark.parametrize("k", range(len(SIZES)))
def test_matches_jax_and_resampling(three_ways, k):
    port, jax, direct = three_ways
    lo, hi, p = port[k]
    for other in (jax[k], direct[k]):
        assert abs(lo - other[0]) < 0.1, (SIZES[k], lo, other)
        assert abs(hi - other[1]) < 0.1, (SIZES[k], hi, other)
        assert abs(p - other[2]) < 0.1, (SIZES[k], p, other)
    assert lo <= hi and 0.0 <= p <= 1.0


def test_edges():
    out = B.bootstrap_cis_device([np.array([3.0]), np.array([]),
                                  np.array([1.0, 2.0])], 500, seed=0,
                                 device="cpu")
    lo, hi, p = out[0]
    assert lo == hi == 3.0 and p == 0.0    # n = 1: every median is the value
    assert all(np.isnan(v) for v in out[1])
    lo2, hi2, _ = out[2]
    assert 1.0 <= lo2 <= hi2 <= 2.0        # n = 2: medians in {1, 1.5, 2}


def test_all_empty_gives_nans_without_work():
    out = B.bootstrap_cis_device([np.array([]), np.array([])], 100,
                                 device="cpu")
    assert all(np.isnan(v) for t in out for v in t)


def test_same_seed_same_numbers_other_seed_other_numbers():
    cohorts = _cohorts()
    a = B.bootstrap_cis_device(cohorts, 4000, seed=7, device="cpu")
    b = B.bootstrap_cis_device(cohorts, 4000, seed=7, device="cpu")
    c = B.bootstrap_cis_device(cohorts, 4000, seed=8, device="cpu")
    assert a == b
    assert a != c


def test_chunks_follow_the_budget_not_free_memory(monkeypatch):
    """The chunk size is a function of (cohort width, bs, budget): asking
    for the device's free memory is never part of it, and one budget gives
    the same numbers on every call."""
    def no_query(*a, **k):
        raise AssertionError("free memory was queried")
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_query)
    cohorts = _cohorts() * 3
    bs = 3000
    budget = 3 * (bs * B._BYTES_PER_DRAW + 128 * 4)
    assert B.rows_per_chunk(128, bs, budget) == 3
    monkeypatch.setattr(B, "CHUNK_BYTES", budget)
    before = B.STATS["chunks"]
    a = B.bootstrap_cis_device(cohorts, bs, seed=2, device="cpu")
    assert B.STATS["chunks"] - before == 4          # 12 rows, 3 a chunk
    assert a == B.bootstrap_cis_device(cohorts, bs, seed=2, device="cpu")


def test_chunk_count_does_not_move_the_distribution(monkeypatch):
    """One chunk or one row a chunk: the numbers differ (the chunks draw
    in turn from one generator), the percentiles agree within the noise."""
    cohorts = _cohorts()
    one = B.bootstrap_cis_device(cohorts, BS, seed=4, device="cpu")
    monkeypatch.setattr(B, "CHUNK_BYTES", BS * B._BYTES_PER_DRAW + 128 * 4)
    rows = B.bootstrap_cis_device(cohorts, BS, seed=4, device="cpu")
    for (lo1, hi1, _), (lo2, hi2, _) in zip(one, rows):
        assert abs(lo1 - lo2) < 0.1 and abs(hi1 - hi2) < 0.1


def test_rows_per_chunk():
    assert B.rows_per_chunk(300, 10000, B.CHUNK_BYTES) == (1 << 24) // 10000
    assert B.rows_per_chunk(300, 10000,
                            budget=10 * (10000 * 64 + 300 * 4)) == 10
    with pytest.raises(ValueError):
        B.rows_per_chunk(300, 10000, budget=100)


def test_the_card_is_required_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        B.bootstrap_cis_device(_cohorts(), 100, device="cuda")
    with pytest.raises(ValueError):
        B.check_device("mps")


def test_medians_stay_inside_the_cohort():
    """Every bootstrap median lies between the cohort's extremes and is a
    value or a midpoint of two values of the sorted cohort (the clamp keeps
    x rounded to 1.0 in float32 inside)."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.normal(size=9)).astype(np.float32)
    pad = np.full(3, np.inf, np.float32)
    xs = torch.from_numpy(np.concatenate([x, pad]))[None]
    g = torch.Generator().manual_seed(0)
    meds = B.bootstrap_medians(xs, torch.tensor([9]), 5000, g)[0].numpy()
    assert np.isfinite(meds).all()
    assert meds.min() >= x[0] and meds.max() <= x[-1]
    mids = set(x.tolist()) | {float(np.float32(0.5) * (a + b))
                              for a in x for b in x}
    assert set(meds.tolist()) <= mids
