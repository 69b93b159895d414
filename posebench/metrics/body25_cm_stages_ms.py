"""body25_cm_stages_ms: the card's busy time per request, in the traced stretch
that records the device, of the kernels launched inside the port's
``b25.cm_stages`` span (BODY_25's forward, f32 or int8)."""

from posebench.core import launch_spans

SPAN = "b25.cm_stages"


def read(ctx):
    return launch_spans.busy_ms_per_request(ctx, SPAN)
