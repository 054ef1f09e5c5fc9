"""The window's arithmetic: whole passes, the pass in flight finished and
counted, the rate over the time to the end of the last pass."""

from __future__ import annotations

from harness import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_pass_in_flight_finishes_and_counts():
    clock = Clock()
    calls = []

    def one_pass(k):
        calls.append(k)
        clock.t += 3.0          # a pass of three seconds

    t0, spans = window.run_window(one_pass, 10.0, clock)
    # passes end at 3, 6, 9 and 12 s: the fourth starts before 10 s, counts
    assert calls == [0, 1, 2, 3]
    assert spans[-1] == (109.0, 112.0)
    assert window.rate(1000, t0, spans) == 4000 / 12.0


def test_nothing_runs_between_passes():
    clock = Clock()

    def one_pass(k):
        clock.t += 2.5

    t0, spans = window.run_window(one_pass, 5.0, clock)
    assert spans[0][0] == t0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert len(spans) == 2 and window.rate(10, t0, spans) == 20 / 5.0


def test_a_pass_longer_than_the_window_counts_whole():
    clock = Clock()

    def one_pass(k):
        clock.t += 30.0

    t0, spans = window.run_window(one_pass, 10.0, clock)
    assert len(spans) == 1 and window.rate(6, t0, spans) == 6 / 30.0


def test_rate_reader_matches_the_window():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "metrics", "reads_per_s.py")
    spec = importlib.util.spec_from_file_location("reads_per_s", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    spans = [(0.5, 4.0), (4.0, 8.25)]
    assert mod.read({"reads_per_pass": 33, "t0": 0.5, "spans": spans}) == \
        66 / 7.75
