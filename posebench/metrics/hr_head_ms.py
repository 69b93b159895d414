"""hr_head_ms: the card's busy time per request, in the traced stretch that
records the device, of the kernels launched inside the port's ``hr.head``
spans (HigherHRNet's final layers, the deconv and its blocks, both passes,
and the aggregation of the maps to the input size)."""

from posebench.core import launch_spans

SPAN = "hr.head"


def read(ctx):
    return launch_spans.busy_ms_per_request(ctx, SPAN)
