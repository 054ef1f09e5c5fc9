"""Shared state that the port's shard threads touch at once: the 2^n
scorer must not flip process-global matmul flags, the launch and stage
counters must not lose increments, and the hit-capacity table must be
loaded whole before any thread sizes a launch from it."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from phaser_tpu_torch.engine import blocks, connections, phasing
from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.kernels import phasescore
from phaser_tpu_torch.mapper import dispatch as D
from phaser_tpu_torch.utils.counters import bump


@pytest.fixture
def fast_switching():
    """Thread switches every 10 us, so that races show within the test."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(target, n, timeout=120):
    threads = [threading.Thread(target=target, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def _exact_scores(M, n):
    """v^T M v of every leading-zero config, in int64 numpy."""
    S = 1 << (n - 1)
    cfg = np.arange(S)[:, None]
    bits = np.zeros((S, n), np.int64)
    bits[:, 1:] = (cfg >> np.arange(n - 2, -1, -1)[None, :]) & 1
    V = np.zeros((S, 2 * n), np.int64)
    np.put_along_axis(V, 2 * np.arange(n)[None, :] + bits, 1, axis=1)
    return ((V @ M.astype(np.int64)) * V).sum(axis=1)


def test_scorer_leaves_tf32_flag_alone(fast_switching):
    """8 scorer threads with TF32 allowed by the caller: the flag reads
    True throughout and afterwards, and every score is exact."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rng = np.random.default_rng(5)
        inputs = []
        for i in range(8):
            n = 10 + i % 4
            inputs.append((n, (rng.random((2 * n, 2 * n)) < 0.3)
                           .astype(np.float32)))
        got = [None] * 8
        done = threading.Event()
        seen = []

        def score(i):
            n, M = inputs[i]
            got[i] = [phasescore.enumerate_scores(torch.from_numpy(M), n)
                      for _ in range(5)]

        def watch():
            while not done.is_set():
                seen.append(torch.backends.cuda.matmul.allow_tf32)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            _run_threads(score, 8)
        finally:
            done.set()
            watcher.join(10)
        assert seen and all(seen), "the scorer switched TF32 off"
        assert torch.backends.cuda.matmul.allow_tf32 is True
        for (n, M), outs in zip(inputs, got):
            want = _exact_scores(M, n)
            for s in outs:
                np.testing.assert_array_equal(s.numpy(), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("counts,key", [
    (K.LAUNCHES, "affine_nibble"), (D.RELAUNCHES, "capacity"),
    (connections.COUNTS, "host_reads"), (blocks.COUNTS, "device_calls"),
    (phasing.COUNTS, "device_calls")],
    ids=["LAUNCHES", "RELAUNCHES", "connections", "blocks", "phasing"])
def test_counter_bumps_are_exact(fast_switching, monkeypatch, counts, key):
    """8 threads x 1000 increments of a counter the CLI and the smoke read:
    no increment is lost."""
    monkeypatch.setitem(counts, key, 0)

    def work(_):
        for _ in range(1000):
            bump(counts, key)

    _run_threads(work, 8)
    assert counts[key] == 8000


def test_cap_load_is_whole_before_use(tmp_path, monkeypatch):
    """Two threads size their first launches while the cap file is still
    being read: both wait for the whole table and get the file's cap, not
    the element-count default."""
    key = ("affine_win", 1024, 64)
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "hit_caps.json").write_text(json.dumps({"affine_win:1024:64":
                                                     50_000}))
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(cache))
    monkeypatch.setattr(D, "_cap_loaded", False)
    monkeypatch.setattr(D, "_cap_feedback", {})
    real_load = json.load
    start = threading.Barrier(2)

    def slow_load(fh):
        # the first reader holds the file while the second thread asks
        threading.Event().wait(0.3)
        return real_load(fh)

    monkeypatch.setattr(json, "load", slow_load)
    caps = [None, None]

    def size(i):
        start.wait()
        if i:
            threading.Event().wait(0.05)
        caps[i] = D._adaptive_cap(key, 1024 * 128)

    _run_threads(size, 2)
    assert caps == [D._next_pow2(8 * 50_000)] * 2, caps
