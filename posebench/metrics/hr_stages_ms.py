"""hr_stages_ms: the card's busy time per request, in the traced stretch
that records the device, of the kernels launched inside the port's
``hr.stages`` span (HigherHRNet's transitions and stages 2-4, both
passes)."""

from posebench.core import launch_spans

SPAN = "hr.stages"


def read(ctx):
    return launch_spans.busy_ms_per_request(ctx, SPAN)
