"""p95 and window arithmetic on synthetic timings."""

import pytest

from posebench.core.timing import percentile, window_stats


def test_percentile_nearest_rank():
    values = list(range(1, 101))          # 1 .. 100
    assert percentile(values, 95) == 95
    assert percentile(values, 50) == 50
    assert percentile(values[::-1], 95) == 95
    assert percentile([7.0], 95) == 7.0
    assert percentile(list(range(1, 21)), 95) == 19   # ceil(19.0)
    with pytest.raises(ValueError):
        percentile([], 95)


def test_window_stats_closed_loop():
    # 10 requests of 30 ms, back to back, plus 1 ms of loop between them,
    # and one slow request of 130 ms
    t0, starts, ends, t = 100.0, [], [], 100.0
    for i in range(11):
        starts.append(t)
        t += 0.130 if i == 5 else 0.030
        ends.append(t)
        t += 0.001
    s = window_stats(t0, starts, ends)
    assert s["completed"] == 11
    assert s["frame_ms"] == pytest.approx((ends[-1] - t0) * 1e3 / 11)
    assert s["frame_ms"] == pytest.approx((10 * 30 + 130 + 10) / 11)
    assert s["frame_ms_p95"] == pytest.approx(130.0)
    assert s["frame_ms_p50"] == pytest.approx(30.0)
    with pytest.raises(ValueError):
        window_stats(t0, [], [])
