"""loop_frame_ms: frame_ms of a cell that does not report it end to end:
the untraced window's milliseconds over the requests completed in it (host
clock, closed loop), read in a ``--trace 1`` run."""


def read(ctx):
    return ctx.stats["frame_ms"]
