"""gpu_busy_ms: milliseconds per request in which some kernel, copy or
fill ran on the card, over the whole window and every request completed in
it: the card's time a frame costs.  The window runs under the profiler
(the device's activity and the host's user spans alone) in a run without
``--trace`` for a cell that reports this metric."""

from posebench.core import trace


def read(ctx):
    evs = ctx.window_events
    dev = trace.device_events(evs) if evs is not None else []
    if not dev:
        return None
    busy = trace.busy_ns(dev, min(e.start for e in dev),
                         max(e.end for e in dev))
    return busy / ctx.stats["completed"] * 1e-6
