"""postprocess_enqueue_ms: host time per request in the port's
``pose.postprocess`` and ``crop.postprocess`` spans (the pose
postprocess, or every crop's tail and their stack, enqueued), read in the
traced stretch that records the host's spans alone."""

SPANS = ("pose.postprocess", "crop.postprocess")


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name in SPANS]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
