"""fetch_ms: host time per request in the port's ``pose.fetch`` and
``crop.fetch`` spans (the one device-to-host copy of the results, the
host's wait for the card there, and the unpacking into poses or keypoint
lists), read in the traced stretch that records the host's spans
alone."""

SPANS = ("pose.fetch", "crop.fetch")


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name in SPANS]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
