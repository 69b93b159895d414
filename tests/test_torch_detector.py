"""End-to-end parity of the torch ``PoseDetector`` with the JAX one, on the
CPU, plus the port's import hygiene and detector contracts.

No pretrained weights exist, so both detectors run the full 6-stage
CocoPoseNet on the same seeded random params, calibrated by the JAX
package's ``calibrate_output_convs`` so the maps carry real peaks, and the
subset filter is relaxed as in ``tests/test_golden_parity.py``.  At
``img_size=96`` a 96x128 frame needs no input resize, so both detectors see
the same pixels.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import NUM_JOINTS, InferenceConfig
from tpupose.ops.postprocess import postprocess_pose as jax_postprocess
from tpupose_torch.detectors.pose import PoseDetector, emit_result
from tpupose_torch.ops.postprocess import PoseResult, postprocess_pose

from test_torch_ops import assert_pose_results_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                      n_subset_limbs_thresh=2, subset_score_thresh=0.05)


def _frame(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)


@pytest.fixture(scope="module")
def detectors():
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose.utils.calibrate import calibrate_output_convs

    jdet = JaxPoseDetector("posenet", cfg=CFG)
    assert calibrate_output_convs(jdet, _frame())
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jdet.variables))
    tdet = PoseDetector(params=params, cfg=CFG, device="cpu")
    return jdet, tdet


def test_maps_match_jax(detectors):
    jdet, tdet = detectors
    (jpaf, jhm), jscale = jdet.compute_maps(_frame())
    (tpaf, thm), tscale = tdet.compute_maps(_frame())
    assert jscale == tscale
    for t, j in ((tpaf, jpaf), (thm, jhm)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        # float32 through 40 conv layers in other summation orders.
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())


def test_postprocess_on_jax_maps_equals_jax_result(detectors):
    jdet, _ = detectors
    (paf, hm), _ = jdet.compute_maps(_frame())
    map_w = paf.shape[-1]
    ref = jax_postprocess(paf, hm, jnp.float32(map_w), CFG)
    got = postprocess_pose(torch.from_numpy(np.array(paf)),
                           torch.from_numpy(np.array(hm)), map_w, CFG)
    assert_pose_results_equal(got, ref)
    assert int(got.num_peaks) > 20 and int(got.valid.sum()) >= 1


def _assert_pose_tables_match(got_poses, got_scores, ref_poses, ref_scores,
                              atol=5e-3):
    """Order-insensitive multiset match of (pose, score) rows; atol covers
    float32 map differences carried into scores and rescaled coordinates."""
    assert len(got_poses) == len(ref_poses)
    remaining = list(range(len(ref_poses)))
    for gp, gs in zip(got_poses, got_scores):
        match = next((i for i in remaining
                      if np.abs(ref_poses[i] - gp).max() <= atol
                      and abs(ref_scores[i] - gs) <= atol), None)
        assert match is not None, f"unmatched pose (score {gs})"
        remaining.remove(match)


def test_detector_pose_table_matches_jax(detectors):
    jdet, tdet = detectors
    for seed in (0, 1):
        ref_poses, ref_scores = jdet(_frame(seed))
        poses, scores = tdet(_frame(seed))
        assert poses.shape[1:] == (NUM_JOINTS, 3)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)
    assert len(poses) >= 1


def test_detect_batch_equals_call(detectors):
    _, tdet = detectors
    frames = np.stack([_frame(0), _frame(1)])
    batch = tdet.detect_batch(frames)
    for frame, (poses, scores) in zip(frames, batch):
        ref_poses, ref_scores = tdet(frame)
        # one batched forward vs two single ones: float32 sums may differ
        # by ulps, which the pose table's atol covers.
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores,
                                  atol=1e-4)


def test_import_leaves_out_jax_flax_and_cv2():
    """The port's modules import nothing of JAX, Flax, cv2 or the JAX
    package ``tpupose``, not even its jax-free modules; the crop detectors,
    the drawing, the demo and the serving apps import cv2 only inside the
    functions that draw, read files or decode encoded request bodies."""
    code = ("import sys, tpupose_torch.detectors.pose, "
            "tpupose_torch.utils.calibrate, tpupose_torch.quant, "
            "tpupose_torch.weights, tpupose_torch.detectors.face, "
            "tpupose_torch.detectors.hand, tpupose_torch.detectors.draw, "
            "tpupose_torch.apps.demo, tpupose_torch.serving, "
            "tpupose_torch.apps.serve, tpupose_torch.apps.export_serving, "
            "tpupose_torch.detectors.bucketed; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'cv2', 'tpupose')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_training_imports_leave_out_jax_optax_orbax_and_cv2():
    """The training path (``train``, ``data``, the Caffe reader, the
    reports and the training apps) imports nothing of JAX, Flax, optax,
    orbax, cv2 or ``tpupose``; cv2 and matplotlib load only inside the
    functions that decode images or plot."""
    code = ("import sys, tpupose_torch.train, tpupose_torch.data, "
            "tpupose_torch.train.checkpoint, tpupose_torch.weights.caffe, "
            "tpupose_torch.utils.reporting, tpupose_torch.apps.train_cli, "
            "tpupose_torch.apps.data_viz, tpupose_torch.apps.gen_masks, "
            "tpupose_torch.apps.convert_model, "
            "tpupose_torch.apps.plot_log; "
            "import tpupose_torch.apps.train_cli as cli; "
            "cli.parse_args(['--synthetic']); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'cv2', 'matplotlib', "
            "'tpupose')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_emit_result_warns_once_on_saturation():
    s_cap = 4
    result = PoseResult(
        poses=torch.zeros(s_cap, NUM_JOINTS, 3), scores=torch.zeros(s_cap),
        valid=torch.zeros(s_cap, dtype=torch.bool),
        num_peaks=torch.tensor(40), peaks_dropped=torch.tensor(8),
        spawns_suppressed=torch.tensor(2))
    with pytest.warns(RuntimeWarning, match="capacity saturated"):
        poses, scores, warned = emit_result(result, 1.0, 1.0)
    assert warned and poses.shape == (0, NUM_JOINTS, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        emit_result(result, 1.0, 1.0, warned=True)


def _host_pyramid_detector():
    PoseDetector(precise=True, device="cpu",
                 cfg=dataclasses.replace(CFG, device_pyramid=False))


def _conv7_xla_quantize():
    PoseDetector(device="cpu", cfg=CFG).quantize([_frame()],
                                                 conv7_impl="xla")


def _conv_nms_postprocess():
    cfg = dataclasses.replace(CFG, nms_mode="conv")
    postprocess_pose(torch.zeros(38, 8, 8), torch.zeros(19, 8, 8), 8, cfg)


@pytest.mark.parametrize("run, error, match", [
    (_host_pyramid_detector, NotImplementedError, "ROADMAP"),
    (_conv7_xla_quantize, ValueError, "no int8 convolution"),
    (_conv_nms_postprocess, ValueError, "ROADMAP"),
], ids=["host_pyramid", "conv7_xla", "conv_nms"])
def test_unported_modes_raise(run, error, match):
    with pytest.raises(error, match=match):
        run()


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseDetector(cfg=CFG)
