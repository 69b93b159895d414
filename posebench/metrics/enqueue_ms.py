"""enqueue_ms: host duration of the port's program span per request (the
upload, the forward and the postprocess enqueued), read in the traced
stretch that records the host's spans alone."""

from posebench.core import trace


def read(ctx):
    if ctx.host_events is None or not ctx.program.program_span:
        return None
    inner = trace.spans(ctx.host_events, ctx.program.program_span)
    if not inner:
        return None
    return sum(s.end - s.start for s in inner) / ctx.requests_traced * 1e-6
