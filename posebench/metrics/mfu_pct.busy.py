"""mfu_pct.busy: the model's operations per request (2 per multiply-add of
every conv, from the configuration's shapes) over the card's busy time per
request in the traced stretch that records the device, times the published
peak of the cell's precision on one H100 (``flops.PEAK_OPS_PER_S``): the
whole step's share of the peak in a cell whose end-to-end time is
gpu_busy_ms."""

from posebench.core import flops, trace


def read(ctx):
    if ctx.events is None or not trace.device_events(ctx.events):
        return None
    p = ctx.program
    ops = flops.forward_ops(ctx.cell.config, p.forward_hw, p.forward_batch)
    seconds = trace.busy_ns(ctx.events, ctx.t0, ctx.t1) * 1e-9 \
        / ctx.requests_traced
    return 100.0 * ops / (seconds * flops.PEAK_OPS_PER_S[p.precision])
