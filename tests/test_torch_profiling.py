"""The port's profiling layer (``tpupose_torch/utils/profiling.py``) on the
CPU: ``StageTimer`` as ``tests/test_utils.py`` holds the JAX package's,
``annotate`` spans in a ``trace()``'s Chrome trace, and the detectors'
spans named as the JAX package names its programs."""

import json
import os

import numpy as np
import pytest
import torch

import tpupose_torch.utils as tutils
from tpupose_torch.config import InferenceConfig
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.utils.profiling import (TRACE_FILE, StageTimer, annotate,
                                           trace)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _span_names(logdir):
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    for _ in range(3):
        with t.stage("fwd") as out:
            out["result"] = torch.ones(8, 8) * 2
    with t.stage("post"):
        pass
    s = t.summary()
    assert s["fwd"]["count"] == 3
    assert s["post"]["count"] == 1
    assert s["fwd"]["total_s"] > 0
    report = t.report()
    assert "fwd" in report and "post" in report


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def test_stage_timer_waits_for_the_result(monkeypatch):
    """``block=True`` waits on the tensors of ``out["result"]`` (any tree);
    here, CPU tensors, it has nothing to wait for and synchronizes no
    device; ``block=False`` does not look at the result."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    t = StageTimer()
    with t.stage("cpu") as out:
        out["result"] = {"a": [torch.zeros(2)], "b": (np.zeros(1), 3)}
    assert synced == []
    cuda_like = torch.zeros(1).as_subclass(_OnCard)
    with t.stage("device") as out:
        out["result"] = [cuda_like]
    with t.stage("unblocked", block=False) as out:
        out["result"] = [cuda_like]
    assert synced == [cuda_like.device]
    assert t.summary()["unblocked"]["count"] == 1


def test_trace_writes_annotated_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("outer_span"):
            with annotate("inner_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    names = _span_names(logdir)
    assert {"outer_span", "inner_span"} <= names
    assert any(n and "mm" in n for n in names)


def test_package_exports_match_jax():
    import tpupose.utils as jutils

    for name in ("StageTimer", "annotate", "trace", "TrainLogger",
                 "dump_run_params"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name


@pytest.fixture(scope="module")
def detector():
    return PoseDetector(cfg=InferenceConfig(img_size=64, heatmap_size=64,
                                            scales=(0.5, 1.0)),
                        device="cpu", seed=0)


def test_detector_spans_carry_program_names(detector, tmp_path):
    """Fast, precise and int8 frames run inside spans named as the JAX
    package's programs: ``pose_fast_HxW`` (network input),
    ``pose_scale_HxW`` (a scale's resized frame),
    ``pose_avg_postprocess_HxW`` (postprocess resolution), and
    ``poseq_*`` once quantized."""
    frame = np.random.RandomState(0).randint(0, 256, (48, 64, 3)).astype(
        np.uint8)
    logdir = str(tmp_path / "t")
    with trace(logdir):
        detector(frame)
        detector.detect_precise(frame)
    names = _span_names(logdir)
    assert {"pose_fast_64x88", "pose_scale_32x43", "pose_scale_64x86",
            "pose_avg_postprocess_48x64"} <= names
    q = PoseDetector(cfg=detector.cfg, device="cpu", seed=0)
    q.quantize([frame])
    logdir = str(tmp_path / "q")
    with trace(logdir):
        q(frame)
        q.detect_precise(frame)
    assert {"poseq_fast_64x88", "poseq_scale_32x43",
            "poseq_avg_postprocess_48x64"} <= _span_names(logdir)


POSE_STAGES = ("pose.resize", "pose.upload", "pose.forward",
               "pose.postprocess", "pose.fetch")
CROP_STAGES = ("crop.upload", "crop.resize", "crop.forward",
               "crop.postprocess", "crop.fetch")


def _frames(n=1):
    return np.random.RandomState(0).randint(0, 256, (n, 48, 64, 3)).astype(
        np.uint8)


def _spans(logdir):
    """[(name, start, end)] of the trace's ``record_function`` spans, in
    microseconds, by start."""
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation")


def _one(spans, name):
    (span,) = [s for s in spans if s[0] == name]
    return span


def _program(spans, prefix):
    (span,) = [s for s in spans if s[0].startswith(prefix)]
    return span


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def quantized(detector):
    q = PoseDetector(cfg=detector.cfg, device="cpu", seed=0)
    q.quantize([_frames()[0]])
    return q


def _check_fast_stages(spans, prefix):
    """Each stage span once; upload, forward and postprocess inside the
    program span, the resize before it, the fetch after it."""
    names = [s[0] for s in spans]
    for stage in POSE_STAGES:
        assert names.count(stage) == 1, (stage, names)
    program = _program(spans, prefix)
    for stage in ("pose.upload", "pose.forward", "pose.postprocess"):
        assert _inside(_one(spans, stage), program), stage
    assert _one(spans, "pose.resize")[2] <= program[1]
    assert _one(spans, "pose.fetch")[1] >= program[2]
    upload, forward, post = (_one(spans, s) for s in POSE_STAGES[1:4])
    assert upload[2] <= forward[1] and forward[2] <= post[1]


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_fast_frame_stage_spans_tile_the_request(detector, quantized,
                                                 precision, tmp_path):
    """One fast frame opens each stage span once, the middle three inside
    the program span (``pose_fast_*``, or ``poseq_fast_*`` once
    quantized), which keeps its extent: after the resize, before the
    fetch."""
    det = detector if precision == "f32" else quantized
    logdir = str(tmp_path / "t")
    with trace(logdir):
        det(_frames()[0])
    spans = _spans(logdir)
    _check_fast_stages(spans, "pose_fast_" if precision == "f32"
                       else "poseq_fast_")
    assert not any(s[0].startswith("crop.") for s in spans)


def test_detect_batch_opens_each_stage_span_once(detector, tmp_path):
    logdir = str(tmp_path / "t")
    with trace(logdir):
        out = detector.detect_batch(_frames(2))
    assert len(out) == 2
    _check_fast_stages(_spans(logdir), "pose_fast_")


def test_precise_frame_gains_postprocess_and_fetch(detector, tmp_path):
    """The pyramid keeps its scale and average spans and gains
    ``pose.postprocess`` (inside ``pose_avg_postprocess_*``) and
    ``pose.fetch`` (after it), and no other stage span."""
    logdir = str(tmp_path / "t")
    with trace(logdir):
        detector.detect_precise(_frames()[0])
    spans = _spans(logdir)
    names = [s[0] for s in spans]
    avg = _program(spans, "pose_avg_postprocess_")
    assert _inside(_one(spans, "pose.postprocess"), avg)
    assert _one(spans, "pose.fetch")[1] >= avg[2]
    assert not {"pose.resize", "pose.upload", "pose.forward"} & set(names)
    assert any(n.startswith("pose_scale_") for n in names)


@pytest.fixture(scope="module")
def hand():
    from tpupose_torch.config import HandConfig
    from tpupose_torch.detectors import HandDetector

    return HandDetector(device="cpu", cfg=HandConfig(img_size=32))


def _hand_crops(n=3):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (24 + 4 * i, 20 + 6 * i, 3)).astype(
        np.uint8) for i in range(n)]


def test_crop_batch_opens_each_stage_span_once(hand, tmp_path):
    """Three hand crops, one left: each ``crop.*`` span once, in order,
    ``crop.postprocess`` once for all three tails."""
    logdir = str(tmp_path / "t")
    with trace(logdir):
        out = hand.detect_batch(_hand_crops(), ["right", "left", "right"])
    assert len(out) == 3
    spans = _spans(logdir)
    names = [s[0] for s in spans]
    for stage in CROP_STAGES:
        assert names.count(stage) == 1, (stage, names)
    stages = [_one(spans, s) for s in CROP_STAGES]
    for before, after in zip(stages, stages[1:]):
        assert before[2] <= after[1], (before, after)
    assert not any(n.startswith("pose") for n in names)


@pytest.mark.parametrize("kind", ["pose", "crop"])
def test_exported_programs_hold_no_span(detector, hand, kind, tmp_path):
    """The bodies that the serving bundles export open no span while they
    are traced, and the saved programs hold no profiler op."""
    from tpupose_torch.serving import save_bundle, save_crop_bundle

    path = str(tmp_path / "bundle")
    logdir = str(tmp_path / "t")
    with trace(logdir):
        if kind == "pose":
            save_bundle(detector, path, [(48, 64)], platforms=("cpu",),
                        batch_sizes=(2,))
        else:
            save_crop_bundle(hand, path, [(24, 20)], batch_sizes=(2,),
                             platforms=("cpu",))
    assert not [s for s in _spans(logdir)
                if s[0] in POSE_STAGES + CROP_STAGES]
    programs = [f for f in os.listdir(path) if f.endswith(".pt2")]
    assert len(programs) == (2 if kind == "pose" else 3)
    for f in programs:
        ep = torch.export.load(os.path.join(path, f))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t], f
