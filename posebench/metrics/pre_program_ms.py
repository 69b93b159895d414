"""pre_program_ms: host time per request from the benchmark's span to the
start of the port's program span (``pose_fast_*``/``poseq_fast_*``): the
detector's entry and its numpy resize, read in the traced stretch that
records the host's spans alone."""

from posebench.core import trace


def read(ctx):
    if ctx.host_events is None or not ctx.program.program_span:
        return None
    frames = trace.spans(ctx.host_events, trace.FRAME_SPAN)
    inner = trace.spans(ctx.host_events, ctx.program.program_span)
    gaps = []
    for f in frames:
        starts = [s.start for s in inner if f.start <= s.start <= f.end]
        if starts:
            gaps.append(min(starts) - f.start)
    return sum(gaps) / len(gaps) * 1e-6 if gaps else None
