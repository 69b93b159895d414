"""upload_ms: host time per request in the port's ``pose.upload`` and
``crop.upload`` spans (the host-to-device copy of the resized frame or
crop batch), read in the traced stretch that records the host's spans
alone."""

SPANS = ("pose.upload", "crop.upload")


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name in SPANS]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
