"""resize_ms: host time per request in the port's ``pose.resize`` and
``crop.resize`` spans (the fast pose path's geometry and numpy resize of
the frame; the crop detector's mirror and numpy resize of every crop),
read in the traced stretch that records the host's spans alone."""

SPANS = ("pose.resize", "crop.resize")


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name in SPANS]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
