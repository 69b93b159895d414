"""conv7_s8_roofline: the least time of the model's int8 7x7 layers at the
cell's shapes (``flops.conv7_bound_s``, whichever kernel runs them) over
the device time of ``conv7_s8_kernel`` in the traced stretch."""

from posebench.core import flops, trace

KERNEL = "conv7_s8_kernel"


def read(ctx):
    p = ctx.program
    if ctx.events is None or p.precision != "int8":
        return None
    ns = trace.kernel_ns(ctx.events, KERNEL, ctx.t0, ctx.t1)
    if not ns:
        return None
    least = flops.conv7_forward_bound_s(ctx.cell.config, p.forward_hw,
                                        p.forward_batch)
    return 100.0 * least * ctx.requests_traced / (ns * 1e-9)
