"""body25_conv_s8_roofline: the least time of BODY_25's 108 non-head int8
layers (``reference/body25.py::conv_s8_forward_bound_s``: every group's
activations, the weights, the per-group mults, the bias, the slopes and
the output moved once, 2 operations per multiply-add, at the card's
published peaks), counted from the configuration, over the device time of
``conv_s8_kernel`` in the traced stretch."""

from posebench.core import trace
from posebench.reference import body25

KERNEL = "conv_s8_kernel"


def read(ctx):
    p = ctx.program
    if (ctx.events is None or p.precision != "int8"
            or ctx.cell.config.get("arch") != "body25"):
        return None
    ns = trace.kernel_ns(ctx.events, KERNEL, ctx.t0, ctx.t1)
    if not ns:
        return None
    least = body25.conv_s8_forward_bound_s(ctx.cell.config, p.forward_hw,
                                           p.forward_batch)
    return 100.0 * least * ctx.requests_traced / (ns * 1e-9)
