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
