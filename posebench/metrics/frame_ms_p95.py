"""frame_ms_p95: the 95th percentile of the window's requests, each timed
on the host clock from the call to its return."""


def read(ctx):
    return ctx.stats["frame_ms_p95"]
