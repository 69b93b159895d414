"""The port's geometry bucketing (``tpupose_torch/detectors/bucketed.py``)
against the JAX package's, on the CPU.

The palette and canvas choice are compared over a grid of sizes; the
wrapper's placement and collect semantics through one scripted fake
detector fed by both packages' wrappers (the canvases must be equal bit for
bit: ``resize_u8_linear`` emulates the JAX side's ``cv2.resize``); and
whole detections on off-palette frames through the full 6-stage
CocoPoseNet at ``img_size=96`` on the same calibrated params, within
``_assert_pose_tables_match``'s 5e-3.  ``detect_batch`` must group frames
by canvas and call the wrapped detector's batched path once per canvas
(the JAX wrapper submits frame by frame).
"""

import numpy as np
import pytest
import torch

from tpupose.detectors.bucketed import BucketedPoseDetector as JaxBucketed
from tpupose.detectors.bucketed import best_canvas as jax_best_canvas
from tpupose.detectors.bucketed import canvas_palette as jax_canvas_palette
from tpupose_torch.detectors.bucketed import (DEFAULT_ASPECTS,
                                              BucketedPoseDetector,
                                              best_canvas, canvas_palette)

from test_torch_detector import _assert_pose_tables_match
from test_torch_serving import CFG, _frame, pose_detectors

CANVASES = [(96, 128), (128, 96)]


def _off_palette_frames():
    """Three frames no canvas fits exactly: a pad band to the right, a
    portrait upscale and a landscape downscale."""
    f0 = _frame(0)
    return [f0[:, :112].copy(),
            np.ascontiguousarray(np.rot90(f0))[:120].copy(),
            np.repeat(f0, 2, axis=0)[:120].copy()]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("base_long", [128, 368, 640, 1000])
def test_palette_and_best_canvas_match_jax(base_long):
    from tpupose.detectors.bucketed import DEFAULT_ASPECTS as JAX_ASPECTS

    assert DEFAULT_ASPECTS == JAX_ASPECTS
    pal = canvas_palette(base_long)
    assert pal == jax_canvas_palette(base_long)
    for h in range(16, 1300, 37):
        for w in range(16, 1300, 53):
            assert best_canvas(h, w, pal) == jax_best_canvas(h, w, pal)


def test_empty_palette_rejected():
    with pytest.raises(ValueError, match="at least one canvas"):
        BucketedPoseDetector(object(), canvases=[])


class _FakeDetector:
    """Records the canvases it was fed; returns scripted canvas-space
    poses; counts its batched calls when it has a batched path."""

    cfg = CFG

    def __init__(self, poses, scores):
        self.poses, self.scores = poses, scores
        self.canvases_seen = []
        self.batch_calls = []

    def submit(self, img):
        self.canvases_seen.append(np.asarray(img).copy())
        return "handle"

    def collect(self, handle):
        assert handle == "handle"
        return np.array(self.poses, np.float64), np.asarray(self.scores)


class _BatchingFake(_FakeDetector):
    def detect_batch(self, imgs):
        self.batch_calls.append(np.asarray(imgs).shape)
        return [self.collect(self.submit(img)) for img in imgs]


def _scripted():
    poses = np.zeros((3, 18, 3))
    poses[0, 0] = (10.0, 20.0, 2.0)     # inside every placed image
    poses[0, 1] = (10.0, 60.0, 2.0)     # deep in a bottom pad band
    poses[1, 2] = (30.0, 55.0, 2.0)     # a whole person in the pad band
    poses[2, 3] = (43.0, 10.0, 2.0)     # 1 px past a 42-px-wide image
    return poses, np.array([1.0, 2.0, 3.0])


@pytest.mark.parametrize("hw", [(32, 48), (48, 32), (20, 20), (64, 64),
                                (33, 97), (120, 40)])
def test_placement_and_collect_match_jax(hw):
    """One fake detector behind both wrappers: the canvas each placed
    frame became is bit-equal, and so is what each wrapper returns."""
    poses, scores = _scripted()
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(
        np.uint8)
    canvases = [(64, 64), (48, 64), (64, 48)]
    fakes, outs = [], []
    for cls in (JaxBucketed, BucketedPoseDetector):
        fake = _FakeDetector(poses, scores)
        outs.append(cls(fake, canvases=canvases, edge_margin=2.0)(img))
        fakes.append(fake)
    np.testing.assert_array_equal(fakes[1].canvases_seen[0],
                                  fakes[0].canvases_seen[0])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_detect_batch_groups_frames_by_canvas():
    """Fault 3.2 of the JAX wrapper, not copied: five frames over two
    canvases make two batched calls, and results come back in input
    order, each equal to the frame's own ``__call__``."""
    poses, scores = _scripted()
    fake = _BatchingFake(poses, scores)
    det = BucketedPoseDetector(fake, canvases=[(64, 64), (48, 96)])
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((60, 60), (40, 90), (32, 32), (24, 48), (50, 50))]
    got = det.detect_batch(frames)
    assert sorted(fake.batch_calls) == [(2, 48, 96, 3), (3, 64, 64, 3)]
    for frame, (p, s) in zip(frames, got):
        ref_p, ref_s = det(frame)
        np.testing.assert_array_equal(p, ref_p)
        np.testing.assert_array_equal(s, ref_s)


def test_detect_batch_without_a_batched_path_submits_each_frame():
    poses, scores = _scripted()
    fake = _FakeDetector(poses, scores)
    det = BucketedPoseDetector(fake, canvases=[(64, 64)])
    frames = [np.zeros((40, 40, 3), np.uint8)] * 3
    assert len(det.detect_batch(frames)) == 3
    assert len(fake.canvases_seen) == 3

    class NoBatchedPrograms(_BatchingFake):
        def batch_sizes(self, image_size):     # a bundle exported without
            return []                          # batch_sizes

    fake = NoBatchedPrograms(poses, scores)
    BucketedPoseDetector(fake, canvases=[(64, 64)]).detect_batch(frames)
    assert fake.batch_calls == [] and len(fake.canvases_seen) == 3


@pytest.fixture(scope="module")
def bucketed_pair():
    jdet, _, tdet = pose_detectors()
    return (JaxBucketed(jdet, canvases=CANVASES),
            BucketedPoseDetector(tdet, canvases=CANVASES), tdet)


def test_off_palette_frames_match_jax(bucketed_pair):
    jb, tb, _ = bucketed_pair
    found = 0
    for frame in _off_palette_frames():
        poses, scores = tb(frame)
        ref_poses, ref_scores = jb(frame)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)
        found += len(poses)
    assert found >= 3


def test_live_detect_batch_groups_by_canvas(bucketed_pair, monkeypatch):
    """Over the live port detector: the two landscape frames share one
    batched call, the portrait one takes another; each result matches the
    frame's ``__call__`` (one batched forward against a single one: float32
    sums may differ by ulps, which the pose table's 1e-4 covers)."""
    _, tb, tdet = bucketed_pair
    calls = []
    live = tdet.detect_batch

    def counted(imgs):
        calls.append(np.asarray(imgs).shape)
        return live(imgs)

    monkeypatch.setattr(tdet, "detect_batch", counted)
    frames = _off_palette_frames()
    got = tb.detect_batch(frames)
    assert sorted(calls) == [(1, 128, 96, 3), (2, 96, 128, 3)]
    for frame, (poses, scores) in zip(frames, got):
        ref_poses, ref_scores = tb(frame)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores,
                                  atol=1e-4)
