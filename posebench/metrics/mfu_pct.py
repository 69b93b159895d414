"""mfu_pct: the model's operations per request (2 per multiply-add of
every conv, from the configuration's shapes) over frame_ms of the untraced
window times the published peak of the cell's precision on one H100
(float32 without tensor cores 67 TFLOP/s, int8 1,979 TOP/s)."""

from posebench.core import flops


def read(ctx):
    if ctx.events is None:
        return None
    p = ctx.program
    ops = flops.forward_ops(ctx.cell.config, p.forward_hw, p.forward_batch)
    seconds = ctx.stats["frame_ms"] * 1e-3
    return 100.0 * ops / (seconds * flops.PEAK_OPS_PER_S[p.precision])
