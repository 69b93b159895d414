"""A run with the timed path broken underneath comes out not correct: an
answer moved or its score altered where it is produced, and half of a
request's batch left out.  The look for a chip is skipped; the cells run on the CPU at 64 px."""

import numpy as np
import pytest

from posebench.tests import tiny


def test_sound_runs_are_correct():
    for name in ("posenet.live_f32", "posenet.live_int8",
                 "handnet.crops8_int8"):
        result = tiny.measure(tiny.tiny_cell(name))
        assert result["correct"], (name, result["checks"])
        assert result["failed"] == 0


@pytest.mark.parametrize("name", ["posenet.live_f32", "posenet.live_int8"])
def test_altered_pose(monkeypatch, name):
    import tpupose_torch.detectors.pose as pose

    emit = pose.emit_result

    def shifted(*args, **kwargs):
        poses, scores, warned = emit(*args, **kwargs)
        poses = poses.copy()
        poses[..., 0] = np.where(poses[..., 2] > 0, poses[..., 0] + 5.0, 0.0)
        return poses, scores, warned

    monkeypatch.setattr(pose, "emit_result", shifted)
    result = tiny.measure(tiny.tiny_cell(name))
    assert not result["correct"]
    assert result["checks"]["persons_unmatched"]["value"] > 0


@pytest.mark.parametrize("name", ["posenet.live_f32", "posenet.live_int8"])
def test_altered_score(monkeypatch, name):
    """Every person in place, its score 0.1% off."""
    import tpupose_torch.detectors.pose as pose

    emit = pose.emit_result

    def scaled(*args, **kwargs):
        poses, scores, warned = emit(*args, **kwargs)
        return poses, np.asarray(scores) * 1.001, warned

    monkeypatch.setattr(pose, "emit_result", scaled)
    result = tiny.measure(tiny.tiny_cell(name))
    assert not result["correct"]
    assert result["checks"]["persons_unmatched"]["value"] == 0
    assert result["checks"]["score_rel_gap"]["value"] > 9e-4


def test_altered_keypoint(monkeypatch):
    from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector

    to_kps = CropKeypointDetector._to_keypoints

    def moved(row, scale=(1.0, 1.0)):
        return [None if k is None else [k[0] + 3, k[1], k[2]]
                for k in to_kps(row, scale)]

    monkeypatch.setattr(CropKeypointDetector, "_to_keypoints",
                        staticmethod(moved))
    result = tiny.measure(tiny.tiny_cell("handnet.crops8_int8"))
    assert not result["correct"]
    assert result["checks"]["keypoints_moved"]["value"] > 0


def test_altered_keypoint_score(monkeypatch):
    """Every keypoint in place, its score scaled by 0.8."""
    from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector

    to_kps = CropKeypointDetector._to_keypoints

    def scaled(row, scale=(1.0, 1.0)):
        return [None if k is None else [k[0], k[1], k[2] * 0.8]
                for k in to_kps(row, scale)]

    monkeypatch.setattr(CropKeypointDetector, "_to_keypoints",
                        staticmethod(scaled))
    result = tiny.measure(tiny.tiny_cell("handnet.crops8_int8"))
    assert not result["correct"]
    assert result["checks"]["keypoints_moved"]["value"] == 0
    assert result["checks"]["score_rel_gap"]["value"] > 0.19


def test_half_the_batch_left_out(monkeypatch):
    from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector

    detect = CropKeypointDetector.detect_crops

    def half(self, crops, flips=None):
        n = len(crops) // 2
        return detect(self, crops[:n], list(flips)[:n] if flips else None)

    monkeypatch.setattr(CropKeypointDetector, "detect_crops", half)
    result = tiny.measure(tiny.tiny_cell("handnet.crops8_int8"))
    assert not result["correct"]
    assert result["checks"]["keypoints_moved"]["value"] > 0
