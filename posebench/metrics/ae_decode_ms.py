"""ae_decode_ms: the card's busy time per request, in the traced stretch
that records the device, of the kernels launched inside the port's
``ae.topk`` span (NMS, top-k, the tag gather and the adjust) and its
``ae.refine`` span (refine of every joint a person lacks), summed: the
associative-embedding decode's device work.  None where neither span
launched a kernel."""

from posebench.core import launch_spans

SPANS = ("ae.topk", "ae.refine")


def read(ctx):
    parts = [launch_spans.busy_ms_per_request(ctx, s) for s in SPANS]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
