"""The trace readers on a small CPU trace recorded here by the harness's
own traced stretch, with device events added by hand where a CPU trace
has none."""

import time
import types

import pytest
import torch
from torch.profiler import record_function

from posebench import run
from posebench.core import flops, registry, trace
from posebench.core.trace import Event


def _request(i):
    time.sleep(0.002)
    with record_function("pose_fast_8x8"):
        torch.randn(16, 16) @ torch.randn(16, 16)
        time.sleep(0.001)
    time.sleep(0.001)
    return i


@pytest.fixture(scope="module")
def recorded():
    evs, answered, failed, seconds = run.traced(_request, 3, 3, "cpu", 0,
                                                with_device=True)
    assert failed == 0 and [i for i, _ in answered] == [0, 1, 2]
    assert seconds > 0.012
    return evs


def _ctx(evs, program_span="pose_fast_", precision="f32", n=3,
         config="posenet"):
    t0, t1 = trace.frame_window(evs)
    return types.SimpleNamespace(
        events=evs, host_events=evs, t0=t0, t1=t1, requests_traced=n,
        traced_s=0.06, window_events=None,
        stats={"frame_ms": 40.0, "completed": n},
        cell=types.SimpleNamespace(config=registry.config(config)),
        program=types.SimpleNamespace(
            program_span=program_span, precision=precision,
            forward_hw=(368, 496), forward_batch=1))


def test_spans_of_a_recorded_trace(recorded):
    frames = trace.spans(recorded, trace.FRAME_SPAN)
    inner = trace.spans(recorded, "pose_fast_")
    assert len(frames) == 3 and len(inner) == 3
    # the host side records the user spans alone, not the matmul's ops
    assert {e.cat for e in recorded} == {"user_annotation"}
    ctx = _ctx(recorded)
    pre = registry.metric_reader("pre_program_ms").read(ctx)
    enq = registry.metric_reader("enqueue_ms").read(ctx)
    assert 1.5 < pre < 20          # the 2 ms sleep before the span
    assert 0.8 < enq < 20          # the 1 ms sleep inside it
    # no device activity on the CPU: the device readers say nothing
    for name in ("launches_per_frame", "device_idle_pct",
                 "conv7_s8_roofline", "conv_s8_roofline"):
        assert registry.metric_reader(name).read(ctx) is None
    assert registry.metric_reader("pre_program_ms").read(
        _ctx(recorded, program_span=None)) is None
    ctx.host_events = None      # no host stretch: the span readers are mute
    for name in ("pre_program_ms", "enqueue_ms"):
        assert registry.metric_reader(name).read(ctx) is None


def _device_trace():
    """Two frames of 10 ms: kernels at known places, one graph launch of
    two kernels sharing a correlation id, a conv7 kernel of 2 ms each."""
    ms = 1_000_000
    evs = [Event("user_annotation", trace.FRAME_SPAN, 0, 10 * ms, 7, 0),
           Event("user_annotation", trace.FRAME_SPAN, 10 * ms, 20 * ms, 7, 0),
           Event("cpu_op", "aten::resize", 0, 4 * ms, 7, 0)]
    for f in (0, 10):
        base = f * ms
        evs += [Event("kernel", "void conv7_s8_kernel<4>(Groups)",
                      base + 4 * ms, base + 6 * ms, 0, 100 + f),
                Event("kernel", "graph_a", base + 6 * ms, base + 7 * ms, 0,
                      200 + f),
                Event("kernel", "graph_b", base + 7 * ms, base + 8 * ms, 0,
                      200 + f),
                Event("gpu_memcpy", "Memcpy DtoH", base + 8 * ms,
                      base + 9 * ms, 0, 300 + f)]
    return sorted(evs, key=lambda e: (e.start, -e.end))


def test_device_readers():
    evs = _device_trace()
    ctx = _ctx(evs, precision="int8", n=2)
    assert trace.busy_ns(evs, ctx.t0, ctx.t1) == 10_000_000
    assert registry.metric_reader("device_idle_pct").read(ctx) == \
        pytest.approx(50.0)
    # conv7 and one graph launch per frame
    assert registry.metric_reader("launches_per_frame").read(ctx) == 2.0
    assert trace.kernel_ns(evs, "conv7_s8_kernel", ctx.t0, ctx.t1) == \
        4_000_000
    least = flops.conv7_forward_bound_s(ctx.cell.config, (368, 496), 1)
    assert registry.metric_reader("conv7_s8_roofline").read(ctx) == \
        pytest.approx(100 * least * 2 / 4e-3)
    assert registry.metric_reader("conv_s8_roofline").read(ctx) is None
    top = trace.top_device_ops(evs, ctx.t0, ctx.t1)
    assert top[0] == ["void conv7_s8_kernel<4>(Groups)", pytest.approx(4e-3)]
    gaps = dict(trace.idle_gaps(evs, ctx.t0, ctx.t1))
    assert gaps["aten::resize"] == pytest.approx(4e-3)
    assert gaps[trace.FRAME_SPAN] == pytest.approx(6e-3)


def test_traced_frame_reader(recorded):
    ctx = _ctx(recorded)
    assert registry.metric_reader("traced_frame_ms").read(ctx) == \
        pytest.approx(20.0)
    ctx.events = None
    assert registry.metric_reader("traced_frame_ms").read(ctx) is None


def test_mfu_reader():
    ctx = _ctx(_device_trace(), precision="f32", n=2)
    ops = 2 * 183_215_400_448
    assert registry.metric_reader("mfu_pct").read(ctx) == pytest.approx(
        100 * ops / (0.040 * 67e12))


def test_split_readers_read_as_the_metric_they_split():
    ctx = _ctx(_device_trace(), precision="int8", n=2)
    for name in ("launches_per_frame", "conv7_s8_roofline",
                 "conv_s8_roofline"):
        assert registry.metric_reader(f"{name}.busy").read(ctx) == \
            registry.metric_reader(name).read(ctx)
    assert registry.metric_reader("loop_frame_ms").read(ctx) == 40.0


def test_busy_readers():
    evs = _device_trace()
    ctx = _ctx(evs, precision="int8", n=2)
    ops = 2 * 183_215_400_448
    # 10 ms of the card's time over the 2 requests of the stretch
    assert registry.metric_reader("mfu_pct.busy").read(ctx) == \
        pytest.approx(100 * ops / (5e-3 * 1979e12))
    gpu = registry.metric_reader("gpu_busy_ms")
    assert gpu.read(ctx) is None            # the window was not traced
    ctx.window_events = evs
    assert gpu.read(ctx) == pytest.approx(5.0)
    ctx.window_events = [e for e in evs if e.cat not in trace.DEVICE_CATS]
    assert gpu.read(ctx) is None            # a window with no device work


def test_window_traced_where_an_end_to_end_metric_reads_the_device():
    bench = registry.benchmark(registry.checkout_root())
    for w in bench["workloads"]:
        reads = any(m["source"] == "device_trace" for m in
                    registry.metrics_for(bench, "end_to_end", w["name"]))
        assert run.window_traced(bench, w["name"], False) == reads
        assert not run.window_traced(bench, w["name"], True)
    assert run.window_traced(bench, "posenet.live_int8", False)


def test_a_traced_window_runs_under_the_profiler(monkeypatch):
    from posebench.tests import tiny

    calls = []
    start = run.start_profiler

    def spy(device, with_device):
        calls.append(with_device)
        return start(device, with_device)

    monkeypatch.setattr(run, "start_profiler", spy)
    result = tiny.measure(tiny.tiny_cell("posenet.live_int8"))
    assert calls == [True] and result["correct"]
    # no card: the window's trace holds no device work to read
    assert set(result["metrics"]) == {"setup_s"}
