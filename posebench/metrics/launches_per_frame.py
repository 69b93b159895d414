"""launches_per_frame: kernel launches in the traced stretch (distinct
correlation ids of the kernels run: a graph launch counts once) per
request."""

from posebench.core import trace


def read(ctx):
    if ctx.events is None:
        return None
    n = trace.launches(ctx.events, ctx.t0, ctx.t1)
    return n / ctx.requests_traced if n else None
