"""ae_refine_roofline: the least time of the port's refine kernel a request
(``reference/higherhrnet.py::refine_bound_s``: each group's heatmap and
tag planes and each pair's mean, key and index moved once, 8 operations a
pair and pixel, at the card's published peaks), from the pairs and groups
a request that the program's counters give since set-up, over the device
time of ``ae_refine_kernel`` a request in the traced stretch."""

from posebench.core import trace
from posebench.reference import higherhrnet

KERNEL = "ae_refine_kernel"


def read(ctx):
    p = ctx.program
    if ctx.events is None or "per_request" not in p.state:
        return None
    ns = trace.kernel_ns(ctx.events, KERNEL, ctx.t0, ctx.t1)
    work = p.state["per_request"]()
    if not ns or not work.get("refine_groups"):
        return None
    least = higherhrnet.refine_bound_s(work["refined"], work["refine_groups"],
                                       p.forward_hw[0] * p.forward_hw[1])
    return 100.0 * least * ctx.requests_traced / (ns * 1e-9)
