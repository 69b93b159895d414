"""The port's host pyramid (``cfg.device_pyramid=False``) and its numpy
emulation of cv2's uint8 INTER_CUBIC, ``resize_u8_cubic``, on the CPU.

``resize_u8_cubic`` must equal ``cv2.resize(..., INTER_CUBIC)`` bit for bit
at every size tested.  It emulates OpenCV's own algorithm, the one
``cv2.ipp.setUseIPP(False)`` selects: wheels that ship Intel's IPP as a
HAL run INTER_CUBIC through IPP's float resize by default, which rounds a
few per cent of the values one level the other way
(``test_ipp_resize_differs_by_at_most_one_level`` pins that).  The parity
of host-pyramid pose tables with the JAX package therefore runs with IPP
off, so both packages resize the same pixels.

Tolerances: resized and padded frames exact; maps 1e-4 x max|ref| (float32
convs in other summation orders); pose tables as
``tests/test_torch_precise.py``'s, coordinates within 5e-3 px and scores
within 5e-3.
"""

import cv2
import numpy as np
import pytest
import torch

from tpupose.config import NUM_JOINTS, InferenceConfig
from tpupose_torch.config import INFERENCE
from tpupose_torch.detectors.pose import PoseDetector, pad_image_np
from tpupose_torch.ops.resize import resize_u8_cubic

from test_torch_precise import _assert_pose_tables_match

CFG = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                      n_subset_limbs_thresh=2, subset_score_thresh=0.05,
                      device_pyramid=False)


def _frame(seed=0, hw=(96, 128)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(
        np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_ipp():
    """cv2's own INTER_CUBIC (IPP off) for one test."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _pyramid_sizes(frame_hw, cfg):
    det = PoseDetector.__new__(PoseDetector)
    det.cfg = cfg
    return [scaled for _, scaled, _ in det._pyramid_geometries(*frame_hw)]


# (in_hw, out_hw) pairs: up- and down-scales, odd sizes, 1-px edges and the
# pyramid sizes of 480x640 and 64x96 frames at the default 368 px
RESIZES = [((1, 1), (5, 7)), ((1, 9), (4, 3)), ((9, 1), (2, 6)),
           ((2, 3), (1, 1)), ((5, 4), (9, 13)), ((17, 23), (9, 13)),
           ((17, 23), (61, 37)), ((64, 96), (64, 95)), ((33, 45), (33, 45)),
           ((101, 99), (3, 200))]
RESIZES += [((480, 640), hw) for hw in _pyramid_sizes((480, 640), INFERENCE)]
RESIZES += [((64, 96), hw) for hw in _pyramid_sizes((64, 96), INFERENCE)]


@pytest.mark.parametrize("in_hw, out_hw", RESIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in RESIZES])
def test_resize_u8_cubic_equals_cv2(no_ipp, in_hw, out_hw):
    rng = np.random.RandomState(in_hw[0] * 1000 + out_hw[1])
    for channels in ((3,), (), (4,)):
        img = rng.randint(0, 256, in_hw + channels).astype(np.uint8)
        ref = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_CUBIC)
        got = resize_u8_cubic(img, out_hw[::-1])
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_resize_u8_cubic_saturates_and_rejects_floats(no_ipp):
    # a hard edge overshoots both ways under Keys' kernel: 0 and 255 clamp
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, 4:] = 255
    got = resize_u8_cubic(img, (29, 31))
    np.testing.assert_array_equal(
        got, cv2.resize(img, (29, 31), interpolation=cv2.INTER_CUBIC))
    with pytest.raises(ValueError, match="uint8"):
        resize_u8_cubic(img.astype(np.float32), (4, 4))


def test_ipp_resize_differs_by_at_most_one_level():
    """What the emulation leaves out: cv2 with IPP on (its default where
    the wheel ships IPP) differs from OpenCV's own INTER_CUBIC by at most
    one level; where it ships none the two are the same."""
    img = _frame(5, (480, 640))
    out_wh = (496, 368)
    was = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(True)
        ipp = cv2.resize(img, out_wh, interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(was)
    got = resize_u8_cubic(img, out_wh)
    diff = np.abs(got.astype(np.int16) - ipp.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.1


@pytest.mark.parametrize("hw", [(92, 124), (96, 128), (1, 1), (8, 16)])
def test_pad_image_np_matches_jax(hw):
    from tpupose.detectors.pose import pad_image_np as jax_pad

    img = _frame(1, hw)
    got, pad = pad_image_np(img, 8, (104, 117, 123))
    ref, ref_pad = jax_pad(img, 8, (104, 117, 123))
    assert pad == ref_pad
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def detectors():
    """(JAX, port) precise host-pyramid detectors on the same calibrated
    seeded weights (4 scales: 48x64 .. 192x256 inputs)."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    fast = PoseDetector(cfg=CFG, device="cpu")
    assert calibrate_output_convs(fast, _frame())
    tdet = PoseDetector(cfg=CFG, precise=True, device="cpu")
    tdet.model = fast.model
    return JaxPoseDetector("posenet", cfg=CFG, precise=True,
                           params=fast.host_weights()), tdet


def test_host_scaled_frames_equal_jax_inputs(no_ipp, detectors):
    """Each scale's resized + padded frame is the JAX package's host input
    (``cv2.resize`` + ``pad_image_np``), pixel for pixel."""
    from tpupose.detectors.pose import pad_image_np as jax_pad

    _, tdet = detectors
    img = _frame(2)
    for _, scaled_hw, padded_hw in tdet._pyramid_geometries(96, 128):
        got, pad = tdet._host_scaled(img[None], scaled_hw)
        ref, ref_pad = jax_pad(
            cv2.resize(img, scaled_hw[::-1], interpolation=cv2.INTER_CUBIC),
            CFG.downscale, CFG.pad_value)
        assert got.shape == (1, *padded_hw, 3) and pad == ref_pad
        np.testing.assert_array_equal(got[0], ref)


def test_host_pyramid_maps_and_tables_match_jax(no_ipp, detectors):
    jdet, tdet = detectors
    assert tdet._fused_small_pair(tdet._pyramid_geometries(96, 128)) is None
    for seed in (0, 1):
        (jpaf, jhm), jscale = jdet.compute_maps(_frame(seed))
        (tpaf, thm), tscale = tdet.compute_maps(_frame(seed))
        assert tscale == jscale
        for t, j in ((tpaf, jpaf), (thm, jhm)):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-4 * np.abs(j).max())
        ref_poses, ref_scores = jdet(_frame(seed))
        poses, scores = tdet(_frame(seed))
        assert poses.shape[1:] == (NUM_JOINTS, 3)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)
    assert len(poses) >= 1


def test_host_pyramid_detect_batch_equals_call(no_ipp, detectors):
    _, tdet = detectors
    frames = np.stack([_frame(0), _frame(3)])
    for frame, (poses, scores) in zip(frames, tdet.detect_batch(frames)):
        ref_poses, ref_scores = tdet(frame)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores,
                                  atol=1e-4)


def test_host_pyramid_bundle_is_refused(detectors, tmp_path):
    """As the JAX package's ``save_bundle``: bundles pin the device
    pyramid."""
    from tpupose_torch import serving

    _, tdet = detectors
    with pytest.raises(ValueError, match="device_pyramid=True"):
        serving.save_bundle(tdet, str(tmp_path / "b"), [(96, 128)],
                            platforms=("cpu",))
