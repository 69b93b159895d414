"""frame_ms: the window's milliseconds over the requests completed in it
(host clock, closed loop)."""


def read(ctx):
    return ctx.stats["frame_ms"]
