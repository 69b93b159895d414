"""Window arithmetic on host-clock timings."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def window_stats(t0: float, starts: Sequence[float], ends: Sequence[float]
                 ) -> dict:
    """Closed-loop window from ``t0``: one request at a time, request i
    from ``starts[i]`` to ``ends[i]`` (seconds).  ``frame_ms`` is the whole
    window, up to the last completion, over the requests completed;
    ``frame_ms_p95`` the 95th percentile of the requests' own times."""
    if not ends:
        raise ValueError("no request completed in the window")
    times_ms = [(e - s) * 1e3 for s, e in zip(starts, ends)]
    return {"frame_ms": (max(ends) - t0) * 1e3 / len(ends),
            "frame_ms_p95": percentile(times_ms, 95.0),
            "frame_ms_p50": percentile(times_ms, 50.0),
            "completed": len(ends),
            "window_s": max(ends) - t0}
