"""The card's busy time of the kernels launched inside a host span.

A kernel belongs to a span when its launching runtime call (matched by
correlation id) starts inside one of the span's intervals on the same host
thread.  The busy time is the union of those kernels' intervals, so it
counts what the span's work cost the card, whichever span's time the
kernels ran in.
"""

from __future__ import annotations

import bisect
from typing import Optional

from posebench.core import trace


def busy_ms_per_request(ctx, span: str) -> Optional[float]:
    """Milliseconds per traced request of the device stretch in which some
    kernel launched inside ``span`` ran; None where the trace holds no such
    span or kernel."""
    if ctx.events is None:
        return None
    evs = ctx.events
    opened = sorted((e.start, e.end, e.thread) for e in evs
                    if e.cat == "user_annotation" and e.name == span
                    and ctx.t0 <= e.start <= ctx.t1)
    if not opened:
        return None
    starts = [s for s, _, _ in opened]
    launched = {}
    for e in evs:
        if e.cat != "cuda_runtime" or not e.corr:
            continue
        i = bisect.bisect_right(starts, e.start) - 1
        if i >= 0 and e.start <= opened[i][1] and e.thread == opened[i][2]:
            launched[e.corr] = True
    kernels = [(e.start, e.end) for e in trace.device_events(
        evs, ctx.t0, ctx.t1) if e.cat == "kernel" and e.corr in launched]
    if not kernels:
        return None
    busy = sum(e - s for s, e in trace.merged(kernels))
    return busy / ctx.requests_traced * 1e-6
