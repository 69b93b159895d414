"""Reading a ``torch.profiler`` trace: events, device busy time, spans.

``events(prof)`` flattens the profiler's kineto events into ``Event``s kept
in memory (nothing is written to disk); the functions below are what the
per-layer metric readers (``metrics/*.py``) are built from.  Times are in
nanoseconds on the profiler's clock, which the host and device events
share.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
FRAME_SPAN = "bench_frame"   # the benchmark's span around each timed call


class Event(NamedTuple):
    cat: str        # "kernel", "gpu_memcpy", "user_annotation", ...
    name: str
    start: int      # ns
    end: int        # ns
    thread: int     # host thread id; 0 for device events
    corr: int       # correlation id of a kernel and its launching call


def _category(e) -> str:
    """The event's kind, from its device, its annotation flag and its
    name (the profiler's ``_KinetoEvent`` has no activity type to read)."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def events(prof) -> List[Event]:
    """The profiler's events, sorted by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(_category(e), e.name(), start,
                         start + e.duration_ns(), int(e.start_thread_id()),
                         int(e.correlation_id())))
    out.sort(key=lambda e: (e.start, -e.end))
    return out


def spans(evs: Iterable[Event], prefix: str) -> List[Event]:
    """Host annotations (``record_function`` spans) whose name starts with
    ``prefix``."""
    return [e for e in evs
            if e.cat == "user_annotation" and e.name.startswith(prefix)]


def device_events(evs: Iterable[Event], t0: int = None, t1: int = None
                  ) -> List[Event]:
    """Kernels, copies and fills that start inside [t0, t1]."""
    return [e for e in evs if e.cat in DEVICE_CATS
            and (t0 is None or e.start >= t0)
            and (t1 is None or e.start <= t1)]


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(evs: Iterable[Event], t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] in which some device operation ran."""
    total = 0
    for s, e in merged((d.start, d.end) for d in device_events(evs)):
        total += max(0, min(e, t1) - max(s, t0))
    return total


def frame_window(evs: Sequence[Event]) -> Tuple[int, int]:
    """First start and last end of the benchmark's frame spans."""
    frames = spans(evs, FRAME_SPAN)
    if not frames:
        raise ValueError("no frame span in the trace")
    return frames[0].start, max(f.end for f in frames)


def kernel_ns(evs: Iterable[Event], needle: str, t0: int, t1: int) -> int:
    """Device time of the kernels whose name contains ``needle``."""
    return sum(e.end - e.start for e in device_events(evs, t0, t1)
               if e.cat == "kernel" and needle in e.name)


def launches(evs: Iterable[Event], t0: int, t1: int) -> int:
    """Kernel launches in [t0, t1]: distinct correlation ids of the kernels
    run, so a graph launch, whose kernels share its id, counts once."""
    return len({e.corr for e in device_events(evs, t0, t1)
                if e.cat == "kernel"})


def top_device_ops(evs: Iterable[Event], t0: int, t1: int, n: int = 10
                   ) -> List[list]:
    """[[name, seconds], ...]: the device operations that took most time."""
    total: Dict[str, int] = defaultdict(int)
    for e in device_events(evs, t0, t1):
        total[e.name] += e.end - e.start
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in ranked]


def idle_gaps(evs: Sequence[Event], t0: int, t1: int, n: int = 10
              ) -> List[list]:
    """[[label, seconds], ...]: the device's idle time in [t0, t1] summed
    by what the measuring thread was doing at each gap's middle, the
    innermost host event there (a span, an op or a runtime call), longest
    first."""
    frames = spans(evs, FRAME_SPAN)
    main = frames[0].thread if frames else None
    busy = merged((d.start, d.end) for d in device_events(evs, t0, t1))
    gaps, last = [], t0
    for s, e in busy:
        if s > last:
            gaps.append((last, min(s, t1)))
        last = max(last, e)
    if last < t1:
        gaps.append((last, t1))
    host = [e for e in evs if e.cat in HOST_CATS and e.thread == main]
    total: Dict[str, int] = defaultdict(int)
    stack: List[Event] = []   # the host events open at the sweep's time
    k = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while k < len(host) and host[k].start <= mid:
            while stack and stack[-1].end < host[k].start:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        total[stack[-1].name if stack else "host outside any span"] += e - s
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in ranked]
