"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or fill ran on the card."""

from posebench.core import trace


def read(ctx):
    if ctx.events is None or not trace.device_events(ctx.events):
        return None
    busy = trace.busy_ns(ctx.events, ctx.t0, ctx.t1)
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))
