"""conv_s8_roofline: the least time of the model's int8 1x1 and 3x3 layers
that are not heads (``flops.conv_s8_bound_s``) over the device time of
``conv_s8_kernel`` in the traced stretch."""

from posebench.core import flops, trace

KERNEL = "conv_s8_kernel"


def read(ctx):
    p = ctx.program
    if ctx.events is None or p.precision != "int8":
        return None
    ns = trace.kernel_ns(ctx.events, KERNEL, ctx.t0, ctx.t1)
    if not ns:
        return None
    least = flops.conv_s8_forward_bound_s(ctx.cell.config, p.forward_hw,
                                          p.forward_batch)
    return 100.0 * least * ctx.requests_traced / (ns * 1e-9)
