"""Parity of the port's precise (multi-scale pyramid) path and the
``_from_rows`` postprocess pair with the JAX package's, on the CPU.

Both detectors run the full 6-stage CocoPoseNet on the same calibrated
random params (as ``tests/test_torch_detector.py``) with the default four
scales at ``img_size=96``, so the pyramid runs at 48x64 .. 192x256 inputs.

Tolerances: geometries exact; cubic resizes 1e-5 (float32 matmuls in other
summation orders); the cubic uint8 emulation of the canvas may move a pixel
by one where the float value sits at a .5 boundary; averaged maps
1e-4 x max|ref|; pose tables 5e-3 (as the fast path's test).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import LIMBS_FROM, LIMBS_TO, NUM_JOINTS, InferenceConfig
from tpupose.ops import paf as jpaf
from tpupose.ops import postprocess as jpost
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops import paf as tpaf
from tpupose_torch.ops import postprocess as tpost
from tpupose_torch.ops.resize import resize_cv2_cubic

from oracles import oracle_peaks
from test_postprocess import _peaks_from_oracle, _render_scene
from test_torch_ops import CFG as SCENE_CFG
from test_torch_ops import _torch_peaks, assert_pose_results_equal

CFG = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                      n_subset_limbs_thresh=2, subset_score_thresh=0.05)
FUSED = dataclasses.replace(CFG, fuse_small_scales=True)


def _frame(seed=0, hw=(96, 128)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(
        np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose.utils.calibrate import calibrate_output_convs

    jdet = JaxPoseDetector("posenet", cfg=CFG)
    assert calibrate_output_convs(jdet, _frame())
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jdet.variables))


@pytest.fixture(scope="module")
def detectors(params):
    """(JAX, port) precise detector pairs by config name."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    return {name: (JaxPoseDetector("posenet", cfg=cfg, params=params,
                                   precise=True),
                   PoseDetector(params=params, cfg=cfg, precise=True,
                                device="cpu"))
            for name, cfg in (("separate", CFG), ("fused", FUSED))}


@pytest.mark.parametrize("hw, cap", [((96, 128), 0), ((480, 640), 0),
                                     ((37, 53), 0), ((480, 640), 320),
                                     ((1080, 1920), 584)])
def test_pyramid_geometries_match_jax(detectors, hw, cap):
    jdet, tdet = detectors["separate"]
    cfg = dataclasses.replace(CFG, max_postprocess_len=cap)
    jdet.cfg = tdet.cfg = cfg
    try:
        assert tdet._pyramid_geometries(*hw) == jdet._pyramid_geometries(*hw)
        assert tdet._postprocess_hw(*hw) == jdet._postprocess_hw(*hw)
    finally:
        jdet.cfg = tdet.cfg = CFG


@pytest.mark.parametrize("in_hw, out_hw", [((13, 17), (29, 7)),
                                           ((46, 62), (368, 496)),
                                           ((96, 128), (49, 65))])
def test_resize_cv2_cubic_matches_jax(in_hw, out_hw):
    from tpupose.ops.resize import resize_cv2_cubic as jax_cubic

    x = np.random.RandomState(1).randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jax_cubic(jnp.asarray(x), out_hw))
    got = resize_cv2_cubic(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_scaled_canvas_matches_jax(detectors):
    """The cubic resize with cv2's uint8 rounding on a pad_value canvas."""
    jdet, tdet = detectors["separate"]
    imgs = np.stack([_frame(2), _frame(3)])
    for scaled_hw, canvas_hw in (((49, 65), (56, 72)), ((192, 256),
                                                         (192, 256))):
        ref = np.asarray(jdet._scaled_on_canvas_traced(
            jnp.asarray(imgs), scaled_hw, canvas_hw))
        got = tdet._scaled_on_canvas(torch.from_numpy(imgs), scaled_hw,
                                     canvas_hw).numpy()
        assert got.shape == ref.shape == (2, *canvas_hw, 3)
        diff = np.abs(got - ref)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() < 1e-3
        s_h, s_w = scaled_hw
        assert np.all(got[:, s_h:] == CFG.pad_value)
        assert np.all(got[:, :, s_w:] == CFG.pad_value)


@pytest.mark.parametrize("name, seeds", [("separate", (0, 1)),
                                         ("fused", (1,))])
def test_precise_maps_and_pose_tables_match_jax(detectors, name, seeds):
    jdet, tdet = detectors[name]
    for seed in seeds:
        (jpaf_, jhm), jscale = jdet.compute_maps(_frame(seed))
        (tpaf_, thm), tscale = tdet.compute_maps(_frame(seed))
        assert tscale == jscale
        for t, j in ((tpaf_, jpaf_), (thm, jhm)):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape
            assert j.shape[-2:] == (96, 128)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-4 * np.abs(j).max())
        ref_poses, ref_scores = jdet(_frame(seed))
        poses, scores = tdet(_frame(seed))
        assert poses.shape[1:] == (NUM_JOINTS, 3)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)
    assert len(poses) >= 1


def _assert_pose_tables_match(got_poses, got_scores, ref_poses, ref_scores,
                              atol=5e-3):
    assert len(got_poses) == len(ref_poses)
    remaining = list(range(len(ref_poses)))
    for gp, gs in zip(got_poses, got_scores):
        match = next((i for i in remaining
                      if np.abs(ref_poses[i] - gp).max() <= atol
                      and abs(ref_scores[i] - gs) <= atol), None)
        assert match is not None, f"unmatched pose (score {gs})"
        remaining.remove(match)


@pytest.mark.parametrize("name", ["separate", "fused"])
def test_precise_detect_batch_equals_call(detectors, name):
    _, tdet = detectors[name]
    frames = np.stack([_frame(0), _frame(1)])
    batch = tdet.detect_batch(frames)
    for frame, (poses, scores) in zip(frames, batch):
        ref_poses, ref_scores = tdet(frame)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores,
                                  atol=1e-4)
    assert sum(len(p) for p, _ in batch) >= 1


def test_fused_pair_is_the_two_smallest_scales(detectors):
    jdet, tdet = detectors["fused"]
    geoms = tdet._pyramid_geometries(96, 128)
    assert tdet._fused_small_pair(geoms) == jdet._fused_small_pair(geoms)
    assert tdet._fused_small_pair(geoms) == (0, 1)
    assert detectors["separate"][1]._fused_small_pair(geoms) is None


@pytest.mark.parametrize("seed, n_people", [(9, 3), (11, 4)])
def test_from_rows_pair_equals_postprocess_pose(seed, n_people):
    pafs, heatmaps = _render_scene(np.random.RandomState(seed),
                                   n_people=n_people)
    img_len = heatmaps.shape[2]
    hw = heatmaps.shape[1:]
    rows = torch.from_numpy(pafs).reshape(len(LIMBS_FROM), 2, -1).transpose(
        1, 2).contiguous()
    got = tpost.postprocess_pose_from_rows(rows, torch.from_numpy(heatmaps),
                                           hw, img_len, SCENE_CFG)
    same = tpost.postprocess_pose(torch.from_numpy(pafs),
                                  torch.from_numpy(heatmaps), img_len,
                                  SCENE_CFG)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    ref = jpost.postprocess_pose_from_rows(
        jnp.asarray(rows.numpy()), jnp.asarray(heatmaps), hw, img_len,
        SCENE_CFG, use_pallas=False)
    assert_pose_results_equal(got, ref)
    assert bool(got.valid.any())

    jp = _peaks_from_oracle(oracle_peaks(heatmaps[:-1], SCENE_CFG),
                            SCENE_CFG.max_peaks_per_joint)
    ref_conns = jpaf.compute_connections_from_rows(
        jnp.asarray(rows.numpy()), hw, jp, jnp.float32(img_len), SCENE_CFG,
        jnp.asarray(LIMBS_FROM), jnp.asarray(LIMBS_TO))
    conns = tpaf.compute_connections_from_rows(
        rows, hw, _torch_peaks(jp), img_len, SCENE_CFG, LIMBS_FROM, LIMBS_TO)
    for name in ("a_slot", "b_slot", "valid"):
        np.testing.assert_array_equal(getattr(conns, name).numpy(),
                                      np.asarray(getattr(ref_conns, name)))
    np.testing.assert_allclose(conns.score.numpy(),
                               np.asarray(ref_conns.score), atol=1e-5)


def test_detect_precise_is_the_precise_call(params, detectors):
    """``detect_precise`` on a precise detector is its ``__call__``; on a
    fast detector it runs the pyramid all the same, as the JAX package's
    does, and matches JAX's ``detect_precise`` there."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    _, tdet = detectors["separate"]
    got, ref = tdet.detect_precise(_frame(0)), tdet(_frame(0))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert len(got[0]) >= 1
    fast = PoseDetector(params=params, cfg=CFG, device="cpu")
    poses, scores = fast.detect_precise(_frame(0))
    np.testing.assert_array_equal(poses, got[0])
    np.testing.assert_array_equal(scores, got[1])
    jfast = JaxPoseDetector("posenet", cfg=CFG, params=params)
    ref_poses, ref_scores = jfast.detect_precise(_frame(0))
    _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)



TINY = ((1, 1, 3), (16, 9, 3), (9, 16, 3))


@pytest.fixture(scope="module")
def raw_params():
    """The JAX detector's seeded weights without the calibration: maps
    near 1e-3, so no peak clears the threshold."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    jdet = JaxPoseDetector("posenet", cfg=CFG)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jdet.variables))


def _tables(det, frame):
    return [det(frame), det.detect_batch(frame[None])[0]]


@pytest.mark.parametrize("mode", ["fast", "precise", "int8"])
def test_tiny_frames(params, raw_params, detectors, mode):
    """1x1, 16x9 and 9x16 frames through ``__call__`` and
    ``detect_batch`` on the fast, precise and int8 paths, as the JAX
    package's ``tests/test_detectors.py`` drives them: (0, 18, 3) tables
    from the uncalibrated weights (JAX's are empty too); with the
    calibrated weights, whose maps carry peaks even on a black frame, the
    f32 tables match JAX's."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose_torch.weights import load_flax_params

    if mode == "precise":
        jdet, det = detectors["separate"]
        load_flax_params(det.model, raw_params)
    else:
        jdet = JaxPoseDetector("posenet", cfg=CFG, params=params)
        det = PoseDetector(params=raw_params, cfg=CFG, device="cpu")
        if mode == "int8":
            det.quantize([_frame(0)])
    try:
        for shape in TINY:
            for poses, scores in _tables(det, np.zeros(shape, np.uint8)):
                assert poses.shape == (0, NUM_JOINTS, 3)
                assert scores.shape == (0,)
    finally:
        if mode != "int8":
            load_flax_params(det.model, params)
    if mode == "int8":
        return
    n = 0
    # JAX compiles a precise program per geometry (~10 s each): one frame
    for shape in TINY if mode == "fast" else TINY[1:2]:
        frame = np.zeros(shape, np.uint8)
        ref_poses, ref_scores = jdet(frame)
        for poses, scores in _tables(det, frame):
            assert poses.shape[1:] == (NUM_JOINTS, 3)
            _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)
        n += len(ref_poses)
    # the fast path's black frames hold people; the pyramid's maps at the
    # frames' own few pixels hold none
    assert n >= 1 if mode == "fast" else n == 0
