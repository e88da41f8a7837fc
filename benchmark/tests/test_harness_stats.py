"""The window's arithmetic on synthetic timings."""

import pytest

from benchmark.harness import stats


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_stall_in_the_window():
    # 99 chunks of 5 ms and one of 2 s: the tail sees the stall only above
    # the 99th percentile, the rate over all the window's time sees it
    lat = [0.005] * 99 + [2.0]
    assert stats.percentile(lat, 95) == 0.005
    assert stats.percentile(lat, 100) == 2.0
    t = 0.0
    ends = []
    for dt in lat:
        t += dt
        ends.append(t)
    frames = 1470 * len(lat)
    r = stats.rate(frames / 44100, 0.0, ends[-1])
    assert r == pytest.approx(frames / 44100 / (99 * 0.005 + 2.0))
    assert r < 0.5 * stats.rate(frames / 44100, 0.0, 99 * 0.005 + 0.005)


def test_rate_needs_a_window():
    with pytest.raises(ValueError):
        stats.rate(1.0, 5.0, 5.0)
