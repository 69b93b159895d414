"""traced_frame_ms: host-clock milliseconds per request of the traced
stretch that records the device's activity: beside frame_ms it gives the
profiler's cost there, by which that stretch's idle share runs high."""


def read(ctx):
    if ctx.events is None:
        return None
    return ctx.traced_s * 1e3 / ctx.requests_traced
