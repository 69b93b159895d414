"""body25_mfu_pct: BODY_25's operations per request (2 per multiply-add of
its 114 convs, ``reference/body25.py::forward_ops``) over the card's busy
time per request in the traced stretch that records the device, times the
published int8 peak of one H100 (``flops.INT8_OPS_PER_S``)."""

from posebench.core import flops, trace
from posebench.reference import body25


def read(ctx):
    p = ctx.program
    if (ctx.events is None or not trace.device_events(ctx.events)
            or ctx.cell.config.get("arch") != "body25"):
        return None
    ops = body25.forward_ops(ctx.cell.config, p.forward_hw, p.forward_batch)
    seconds = trace.busy_ns(ctx.events, ctx.t0, ctx.t1) * 1e-9 \
        / ctx.requests_traced
    return 100.0 * ops / (seconds * flops.PEAK_OPS_PER_S[p.precision])
