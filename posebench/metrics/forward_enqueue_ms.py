"""forward_enqueue_ms: host time per request in the port's
``pose.forward`` and ``crop.forward`` spans (the normalisation, the f32 or
int8 network forward and, on the pose path, the map resizes, enqueued),
read in the traced stretch that records the host's spans alone."""

SPANS = ("pose.forward", "crop.forward")


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name in SPANS]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
