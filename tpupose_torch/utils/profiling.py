"""Tracing and profiling (port of ``tpupose/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` session over CPU and CUDA
  activity that writes a Chrome / Perfetto trace (``trace.json``) into
  ``logdir``;
* ``annotate(name)``: a named span in that trace (``record_function``),
  plus an NVTX range once CUDA is in use;
* ``StageTimer``: named wall-clock timers whose stages wait for their
  result before the clock stops.

The detectors run their per-frame work inside ``annotate`` spans named as
the JAX package names its programs: ``pose_fast_HxW`` and
``poseq_fast_HxW`` (network input size), ``pose_scale_HxW`` (a pyramid
scale's resized size) and ``pose_avg_postprocess_HxW`` (postprocess
resolution).  Stage spans tile a request: ``pose.resize``, then
``pose.upload``, ``pose.forward`` and ``pose.postprocess`` inside the
program span, then ``pose.fetch``; the crop detectors' ``crop.resize``,
``crop.upload``, ``crop.forward``, ``crop.postprocess`` and
``crop.fetch``.  No span opens inside a body that ``serving.py`` exports.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch
from torch.utils import _pytree as pytree

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile CPU and, when available, CUDA activity; on exit write the
    trace to ``<logdir>/trace.json`` (chrome://tracing, Perfetto).  Yields
    the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named span for the profiler timeline; also an NVTX range when this
    process has initialised CUDA (Nsight reads those)."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _wait(result) -> None:
    """Block until ``result``'s device work is done: synchronise every CUDA
    device one of its tensors lives on (CPU work is already done)."""
    devices = {leaf.device for leaf in pytree.tree_leaves(result)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name.

    ``block=True`` (default) waits for ``out["result"]`` (any tree of
    tensors) before stopping the clock, so a stage's queued device work is
    charged to it rather than to the next stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = True):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if block and "result" in out:
                _wait(out["result"])
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / self.counts[name],
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'stage':<24s} {'count':>6s} {'mean ms':>10s} "
                 f"{'total s':>9s}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24s} {s['count']:>6d} "
                         f"{s['mean_ms']:>10.2f} {s['total_s']:>9.3f}")
        return "\n".join(lines)
