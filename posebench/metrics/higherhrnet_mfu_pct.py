"""higherhrnet_mfu_pct: HigherHRNet-W32's operations per request (2 per
multiply-add of its 303 convs over both passes of the flip test,
``reference/higherhrnet.py::forward_ops`` at batch 2) over frame_ms of the
untraced window times the published float32 peak of one H100 outside the
tensor cores (67 TFLOP/s), read in a ``--trace 1`` run."""

from posebench.core import flops
from posebench.reference import higherhrnet


def read(ctx):
    p = ctx.program
    if ctx.events is None or ctx.cell.config.get("arch") != "higherhrnet_w32":
        return None
    ops = higherhrnet.forward_ops(ctx.cell.config, p.forward_hw,
                                  p.forward_batch)
    seconds = ctx.stats["frame_ms"] * 1e-3
    return 100.0 * ops / (seconds * flops.PEAK_OPS_PER_S[p.precision])
