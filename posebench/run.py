"""Run one cell of the port's benchmark once and print its result line.

    python3 -m posebench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``tpupose_torch``.  The cell's entry in ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``), which sets up the program from the seed, answers
one request per call and computes the reference's answers.  Each metric
the cell reports is read by ``metrics/<metric>.py``.

A run: set-up (inputs and weights from the seed, the program built,
calibrated, quantized and warmed up: ``setup_s``), a closed-loop window of
``--seconds`` (under ``torch.profiler``, recording the device's activity
and the host's user spans alone, where the cell reports an end-to-end
metric read from the device trace; else with no tracing), and with
``--trace 1``, whose window is never traced, two further
stretches of the traffic's ``trace_requests`` requests each under
``torch.profiler``: the host's user spans alone, then those and every
device operation; then, with the program freed, the reference's answers
for every input and the comparison of every answer given, which decides
``correct``.  The last line of standard output is the result as JSON; the
numbers compared and their limits are also the last lines of standard
error.

It exits non-zero with no result when CUDA or the cell's cards are
missing, when the port cannot be imported, and when a module of the JAX
package or of JAX is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # process start, before the heavy imports

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from posebench.core import guard, registry  # noqa: E402
from posebench.core.cell import Cell  # noqa: E402
from posebench.core.timing import window_stats  # noqa: E402

CACHE_DIR = ".posebench_cache"   # fixed, inside the checkout
RUN_DIR = ".posebench_run"       # cleared by every run


def cache_env(root: str) -> None:
    """Point every compiler cache at a fixed directory in the checkout (the
    port builds its kernels into ``tpupose_torch/_build`` itself)."""
    base = os.path.join(root, CACHE_DIR)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def closed_loop(call, n_inputs: int, seconds: float, device, first: int = 0):
    """Requests one at a time for ``seconds``, cycling the inputs; returns
    (window stats, [(input, answer)], attempted, failed)."""
    answered, starts, ends, failed = [], [], [], 0
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds:
        k = i % n_inputs
        s = time.perf_counter()
        try:
            answer = call(k)
        except Exception as e:   # a failed request: counted, not timed
            failed += 1
            print(f"request {i} failed: {e!r}", file=sys.stderr)
        else:
            ends.append(time.perf_counter())
            starts.append(s)
            answered.append((k, answer))
        i += 1
    _sync(device)
    return window_stats(t0, starts, ends), answered, i - first, failed


@contextlib.contextmanager
def user_spans_only():
    """Have a ``torch.profiler`` started inside this block record only the
    ``record_function`` spans on the host (the benchmark's and the port's),
    not every operator: the device's kernels, copies and CUDA runtime calls
    are recorded as before.  Raises if the profiler did not take it."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    enable = autograd_profiler._enable_profiler
    taken = []

    def scoped(config, activities, scopes=None):
        taken.append(True)
        return enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = scoped
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable
    if not taken:
        raise RuntimeError("the profiler did not start through "
                           "_enable_profiler: host ops would be recorded")


def start_profiler(device, with_device: bool):
    """A started ``torch.profiler`` recording the host's user spans and,
    with ``with_device`` on a card, every device operation and the runtime
    calls that launch them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if with_device and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with user_spans_only():
        prof.__enter__()
    return prof


def window_traced(bench: dict, cell: str, trace_on: bool) -> bool:
    """Whether the window runs under the profiler: in a run without
    ``--trace``, where the cell reports an end-to-end metric read from the
    device trace."""
    return not trace_on and any(
        m["source"] == "device_trace"
        for m in registry.metrics_for(bench, "end_to_end", cell))


def traced(call, n_inputs: int, count: int, device, first: int,
           with_device: bool):
    """``count`` requests under ``torch.profiler``, each in a
    ``bench_frame`` span, recording user spans on the host and, with
    ``with_device`` on a card, every device operation and the runtime calls
    that launch them; returns (events, [(input, answer)], failed,
    host-clock seconds of the stretch)."""
    from torch.profiler import record_function

    from posebench.core import trace

    answered, failed = [], 0
    prof = start_profiler(device, with_device)
    try:
        t0 = time.perf_counter()
        for j in range(count):
            k = (first + j) % n_inputs
            with record_function(trace.FRAME_SPAN):
                try:
                    answered.append((k, call(k)))
                except Exception as e:
                    failed += 1
                    print(f"traced request {j} failed: {e!r}",
                          file=sys.stderr)
        _sync(device)
        seconds = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    return trace.events(prof), answered, failed, seconds


def measure(cell: Cell, bench: dict, seconds: float, trace_on: bool,
            t_start: float, package_dir: str = registry.PACKAGE_DIR):
    """One run of ``cell``; returns the result dict (``checks`` last)."""
    import torch

    from posebench.core import trace

    drv = registry.driver(cell.traffic["driver"], package_dir)
    cuda = torch.device(cell.device).type == "cuda"
    imports_s = time.perf_counter() - t_start
    program = drv.setup(cell)
    _sync(cell.device)
    setup_s = time.perf_counter() - t_start
    # the profiler's start (CUPTI's on a card, some seconds) is the
    # benchmark's, not the program's set-up: it counts in neither
    window_prof = (start_profiler(cell.device, True)
                   if window_traced(bench, cell.name, trace_on) else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    window_events = None
    try:
        stats, answered, attempted, failed = closed_loop(
            program.call, program.n_inputs, seconds, cell.device)
    finally:
        if window_prof is not None:
            window_prof.__exit__(None, None, None)
    if window_prof is not None:
        window_events = trace.events(window_prof)
        del window_prof
    # with --trace 1, two traced stretches: the host's spans alone, where
    # the profiler costs next to nothing, then the device's activity too
    host_events = events = traced_s = host_traced_s = None
    if trace_on:
        n = cell.traffic["trace_requests"]
        for with_device in (False, True):
            evs, more, failed_t, secs = traced(
                program.call, program.n_inputs, n, cell.device, attempted,
                with_device)
            answered += more
            attempted += n
            failed += failed_t
            if with_device:
                events, traced_s = evs, secs
            else:
                host_events, host_traced_s = evs, secs
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    program.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    want = drv.expected(cell, program)
    numbers = drv.numbers(answered, want)
    limits = cell.traffic["limits"]
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    ctx = types.SimpleNamespace(cell=cell, program=program, stats=stats,
                                setup_s=setup_s, events=events,
                                host_events=host_events, traced_s=traced_s,
                                window_events=window_events)
    if events is not None:
        t0, t1 = trace.frame_window(events)
        ctx.t0, ctx.t1 = t0, t1
        ctx.requests_traced = cell.traffic["trace_requests"]
    section = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for entry in registry.metrics_for(bench, section, cell.name):
        value = registry.metric_reader(entry["name"], package_dir).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if events is not None:
        device["busy_s"] = trace.busy_ns(events, ctx.t0, ctx.t1) * 1e-9
        device["window_s"] = (ctx.t1 - ctx.t0) * 1e-9
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(events, ctx.t0, ctx.t1),
            "idle_gaps": trace.idle_gaps(events, ctx.t0, ctx.t1)}
    result["diagnostics"] = dict(drv.diagnostics(program, want), **{
        k: v for k, v in numbers.items() if k not in checks},
        frame_ms_p50=stats["frame_ms_p50"], window_requests=stats[
            "completed"], setup_imports_s=imports_s)
    if window_events is not None:   # every launch of the window recorded
        result["diagnostics"]["window_launches_per_request"] = (
            trace.launches(window_events, 0, 2**63) / stats["completed"])
    if host_traced_s is not None:
        result["diagnostics"]["host_traced_frame_ms"] = (
            host_traced_s * 1e3 / cell.traffic["trace_requests"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = registry.checkout_root()
    cache_env(root)
    run_dir = os.path.join(root, RUN_DIR)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)

    import torch

    if not torch.cuda.is_available():
        print("posebench: CUDA is not available", file=sys.stderr)
        return 2
    bench = registry.benchmark(root)
    w = registry.workload(bench, args.workload)
    if torch.cuda.device_count() < w["chips"]:
        print(f"posebench: {args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    cell = Cell(name=w["name"], config=registry.config(w["config"]),
                traffic=registry.traffic(w["traffic"]), seed=args.seed,
                device="cuda")
    result = measure(cell, bench, args.seconds, bool(args.trace), T_START)

    bad = guard.forbidden_modules()
    if bad:
        print(f"posebench: JAX-side modules loaded: {bad}", file=sys.stderr)
        return 3
    with open(os.path.join(run_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
