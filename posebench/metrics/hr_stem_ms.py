"""hr_stem_ms: the card's busy time per request, in the traced stretch that
records the device, of the kernels launched inside the port's ``hr.stem``
span (HigherHRNet's conv1 to layer1, both passes)."""

from posebench.core import launch_spans

SPAN = "hr.stem"


def read(ctx):
    return launch_spans.busy_ms_per_request(ctx, SPAN)
