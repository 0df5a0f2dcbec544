"""Whole-window arithmetic on synthetic timestamps, and the sample."""

import pytest

from benchmark.window import Reservoir, per_unit_ms, percentile


def test_per_unit_is_whole_window():
    # 7 frames from t=10.0 s to t=10.35 s: 50 ms each, however unevenly.
    assert per_unit_ms(10.0, 10.35, 7) == pytest.approx(50.0)
    # 3 fit jobs of 200 steps in 8.4 s: 14 ms a step, job start and end included.
    assert per_unit_ms(0.0, 8.4, 600) == pytest.approx(14.0)
    with pytest.raises(ValueError):
        per_unit_ms(0.0, 1.0, 0)


def test_frame_ms_not_a_median_of_chunks():
    lat = [0.010] * 90 + [0.100] * 10  # 90 fast frames, 10 slow ones, back to back
    start, t = 0.0, 0.0
    for x in lat:
        t += x
    assert per_unit_ms(start, t, len(lat)) == pytest.approx(19.0)


def test_p95_of_every_frame():
    lat = [float(i) for i in range(1, 101)]  # 1 .. 100 ms
    assert percentile(lat, 0.95) == pytest.approx(95.05)
    assert percentile([5.0], 0.95) == 5.0
    assert percentile([1.0, 2.0], 0.5) == pytest.approx(1.5)


def test_reservoir_is_uniform_and_lazy():
    made = []
    r = Reservoir(3, seed=7)
    for i in range(1000):
        r.offer(i, lambda i=i: made.append(i) or i)
    assert len(r.items) == 3 and all(i == x for i, x in r.items)
    assert len(made) < 40  # only kept items are made: ~3·(1 + ln(1000/3))
    counts = [0] * 10
    for seed in range(2000):
        r = Reservoir(1, seed)
        for i in range(10):
            r.offer(i, lambda i=i: i)
        counts[r.items[0][0]] += 1
    assert min(counts) > 140 and max(counts) < 260
