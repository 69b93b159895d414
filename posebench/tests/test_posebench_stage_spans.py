"""The readers of the port's stage spans (``resize_ms``, ``upload_ms``,
``forward_enqueue_ms``, ``postprocess_enqueue_ms``, ``fetch_ms``) on a
small CPU trace recorded by the harness's own traced stretch, on events
made by hand, and on the port's own spans in tiny cells."""

import time
import types

import pytest
from torch.profiler import record_function

from posebench import run
from posebench.core import registry, trace
from posebench.core.trace import Event

# metric: (pose span, crop span)
READERS = {"resize_ms": ("pose.resize", "crop.resize"),
           "upload_ms": ("pose.upload", "crop.upload"),
           "forward_enqueue_ms": ("pose.forward", "crop.forward"),
           "postprocess_enqueue_ms": ("pose.postprocess",
                                      "crop.postprocess"),
           "fetch_ms": ("pose.fetch", "crop.fetch")}
CELLS = ["posenet.live_f32", "handnet.crops8_int8"]
# seconds each stub stage sleeps
SLEEP = {"resize_ms": 0.004, "upload_ms": 0.0005,
         "forward_enqueue_ms": 0.002, "postprocess_enqueue_ms": 0.001,
         "fetch_ms": 0.003}


def _stub(i):
    """A pose request as the port opens its spans: the resize, then the
    program span holding upload, forward and postprocess, then the
    fetch."""
    with record_function("pose.resize"):
        time.sleep(SLEEP["resize_ms"])
    with record_function("pose_fast_8x8"):
        for metric in ("upload_ms", "forward_enqueue_ms",
                       "postprocess_enqueue_ms"):
            with record_function(READERS[metric][0]):
                time.sleep(SLEEP[metric])
    with record_function("pose.fetch"):
        time.sleep(SLEEP["fetch_ms"])
    return i


@pytest.fixture(scope="module")
def recorded():
    evs, answered, failed, _ = run.traced(_stub, 3, 3, "cpu", 0,
                                          with_device=False)
    assert failed == 0 and len(answered) == 3
    return evs


def _ctx(evs, n=3):
    return types.SimpleNamespace(
        host_events=evs, events=evs, requests_traced=n,
        program=types.SimpleNamespace(program_span="pose_fast_"))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_its_spans_per_request(recorded, metric):
    value = registry.metric_reader(metric).read(_ctx(recorded))
    want = SLEEP[metric] * 1e3
    assert want <= value < want + 10


def test_stage_spans_account_for_the_program_span(recorded):
    """The program span's host time (``enqueue_ms``) holds the three
    stages inside it; the time before it (``pre_program_ms``) holds the
    resize."""
    ctx = _ctx(recorded)
    read = {m: registry.metric_reader(m).read(ctx) for m in
            list(READERS) + ["enqueue_ms", "pre_program_ms"]}
    inner = (read["upload_ms"] + read["forward_enqueue_ms"]
             + read["postprocess_enqueue_ms"])
    assert inner <= read["enqueue_ms"] < inner + 1
    assert read["resize_ms"] <= read["pre_program_ms"] < \
        read["resize_ms"] + 1


def _by_hand():
    """Two requests' spans, pose and crop, with a span of another name
    whose name starts like one of them."""
    ms = 1_000_000
    return [Event("user_annotation", trace.FRAME_SPAN, 0, 30 * ms, 7, 0),
            Event("user_annotation", "pose.resize", 0, 6 * ms, 7, 0),
            Event("user_annotation", "pose.resize_scratch", 0, 5 * ms, 7, 0),
            Event("user_annotation", "crop.resize", 6 * ms, 8 * ms, 7, 0),
            Event("user_annotation", "pose.fetch", 20 * ms, 23 * ms, 7, 0),
            Event("cpu_op", "pose.fetch", 20 * ms, 29 * ms, 7, 0),
            Event("user_annotation", trace.FRAME_SPAN, 30 * ms, 60 * ms, 7,
                  0),
            Event("user_annotation", "pose.resize", 30 * ms, 34 * ms, 7, 0),
            Event("user_annotation", "crop.fetch", 50 * ms, 51 * ms, 7, 0)]


def test_readers_on_events_made_by_hand():
    ctx = _ctx(_by_hand(), n=2)
    # both detectors' spans count; another name or kind does not
    assert registry.metric_reader("resize_ms").read(ctx) == \
        pytest.approx((6 + 2 + 4) / 2)
    assert registry.metric_reader("fetch_ms").read(ctx) == \
        pytest.approx((3 + 1) / 2)
    for metric in ("upload_ms", "forward_enqueue_ms",
                   "postprocess_enqueue_ms"):
        assert registry.metric_reader(metric).read(ctx) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_mute_without_its_spans(recorded, metric):
    reader = registry.metric_reader(metric)
    others = [e for e in recorded if e.name not in READERS[metric]]
    assert reader.read(_ctx(others)) is None
    ctx = _ctx(recorded)
    ctx.host_events = None          # no host stretch
    assert reader.read(ctx) is None


def test_each_reader_goes_to_the_two_host_timed_cells():
    bench = registry.benchmark(registry.checkout_root())
    for w in bench["workloads"]:
        got = {m["name"] for m in registry.metrics_for(bench, "per_layer",
                                                       w["name"])}
        want = set(READERS) if w["name"] in CELLS else set()
        assert got & set(READERS) == want, w["name"]
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == CELLS
            assert (m["source"], m["better"], m["unit"], m["moves"]) == (
                "program_span", "lower", "ms", "frame_ms")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_read_the_ports_spans(cell):
    """A ``--trace 1`` run of a tiny cell on the CPU reports every stage
    metric from the port's own spans."""
    from posebench.tests import tiny

    result = tiny.measure(tiny.tiny_cell(cell), trace_on=True)
    assert result["correct"]
    metrics = result["metrics"]
    for metric in READERS:
        assert metrics[metric]["value"] > 0 and \
            metrics[metric]["unit"] == "ms", metric
