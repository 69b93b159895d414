"""Parity of the port's face and hand detectors, their int8 forward, the
demo cascade and the overlay drawing with the JAX package's, on the CPU.

Both sides run the full 6-stage FaceNet / HandNet at ``img_size=64`` on the
same seeded random weights, whose last-stage output conv is scaled by
``calibrate_crop_output_conv`` so keypoints fall on both sides of the
threshold (a random net's maps peak near 1e-3, far below it).

Tolerances: keypoint coordinates and validity, crop boxes, int8 maps and
trees' integer kernels, and drawn images exact; keypoint scores 1e-5
(float32 convs in other summation orders); int8 scales from the two sides'
own float32 calibrations rtol 1e-5.  The int8 forward is held to JAX's
``quant_apply`` run op by op (a jitted XLA program may contract the
epilogue and move a .5 boundary by one int8 step), fed the same ranges.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import FaceConfig as JaxFaceConfig
from tpupose.config import HandConfig as JaxHandConfig
from tpupose_torch import quant as tq
from tpupose_torch.config import FaceConfig, HandConfig
from tpupose_torch.detectors import FaceDetector, HandDetector
from tpupose_torch.detectors.crop_keypoints import preprocess_crops_u8
from tpupose_torch.utils.calibrate import calibrate_crop_output_conv

SIZE = 64
PORT = {"facenet": (FaceDetector, FaceConfig(img_size=SIZE)),
        "handnet": (HandDetector, HandConfig(img_size=SIZE))}


def _crops(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (40 + 8 * i, 36 + 4 * i, 3)).astype(
        np.uint8) for i in range(n)]


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
def pairs():
    """{arch: (JAX detector, port detector)} on the same calibrated
    weights."""
    from tpupose.detectors import FaceDetector as JaxFaceDetector
    from tpupose.detectors import HandDetector as JaxHandDetector

    out = {}
    for arch, jcls, jcfg in (
            ("facenet", JaxFaceDetector, JaxFaceConfig(img_size=SIZE)),
            ("handnet", JaxHandDetector, JaxHandConfig(img_size=SIZE))):
        cls, cfg = PORT[arch]
        tdet = cls(cfg=cfg, device="cpu", seed=len(arch))
        calibrate_crop_output_conv(tdet, _crops(1))
        params = {"params": tq.model_params(tdet.model)}
        out[arch] = (jcls(arch, cfg=jcfg, params=params), tdet)
    return out


def _assert_keypoints_equal(got, ref):
    assert len(got) == len(ref)
    n_valid = 0
    for g_crop, r_crop in zip(got, ref):
        assert len(g_crop) == len(r_crop)
        for g, r in zip(g_crop, r_crop):
            assert (g is None) == (r is None)
            if r is not None:
                n_valid += 1
                assert g[:2] == r[:2]
                assert abs(g[2] - r[2]) <= 1e-5
    return n_valid


def _set_tail_stride(pair, stride):
    jdet, tdet = pair
    jdet.tail_stride = tdet.tail_stride = stride
    jdet._clear_program_caches()


@pytest.mark.parametrize("stride", [1, 16])
@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_detect_crops_matches_jax(pairs, arch, stride):
    """Mixed crop sizes through one batched forward, left-hand flips in
    the mix, at the exact tail and at ``tail_stride`` 16."""
    pair = pairs[arch]
    _set_tail_stride(pair, stride)
    try:
        jdet, tdet = pair
        crops = _crops(2)
        for flips in ([False] * 3, [True, False, True]):
            ref = jdet.detect_crops(crops, flips)
            got = tdet.detect_crops(crops, flips)
            n_valid = _assert_keypoints_equal(got, ref)
            assert 0 < n_valid < sum(len(k) for k in ref)
    finally:
        _set_tail_stride(pair, 1)


def test_face_and_hand_entry_points_match_jax(pairs):
    jface, tface = pairs["facenet"]
    jhand, thand = pairs["handnet"]
    crops = _crops(3)
    _assert_keypoints_equal([tface(crops[0])], [jface(crops[0])])
    _assert_keypoints_equal(tface.detect_batch(crops),
                            jface.detect_batch(crops))
    _assert_keypoints_equal([thand(crops[1], hand_type="left")],
                            [jhand(crops[1], hand_type="left")])
    types = ["left", "right", "left"]
    batch = thand.detect_batch(crops, types)
    _assert_keypoints_equal(batch, jhand.detect_batch(crops, types))
    # the streaming pair gives the batch, and a single call its crop (a
    # batch of one: oneDNN may sum in another order, scores within 1e-5)
    pending = thand.submit_crops(crops, [t == "left" for t in types])
    assert thand.collect_crops(pending) == batch
    _assert_keypoints_equal([thand(crops[2], hand_type="left")], batch[2:])
    assert tface.detect_batch([]) == [] and thand.detect_batch([], []) == []
    assert thand.collect_crops(thand.submit_crops([])) == []


def _jax_ranges(jdet, crops):
    import cv2

    from tpupose.quant import calibrate_ranges

    frames = np.stack([cv2.resize(c, (SIZE, SIZE)) for c in crops])
    x = jnp.asarray(frames).astype(jnp.float32) / 256.0 - 0.5
    return calibrate_ranges(jdet.model, jdet.variables, x)


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_int8_crop_forward_equals_jax_op_by_op(pairs, arch):
    """One quantized tree, fed to both forwards: every stage's maps equal
    JAX's ``quant_apply`` run op by op, on both of the port's routes."""
    from tpupose.quant import quant_apply, quantize as jax_quantize

    jdet, tdet = pairs[arch]
    crops = _crops(4, n=2)
    jtree, static = jax_quantize(arch, jdet.variables,
                                 _jax_ranges(jdet, crops))
    imgs = tdet.prepare_crops(crops, [False, True])
    ref = np.asarray(quant_apply(static, jtree, jnp.asarray(
        imgs).astype(jnp.float32) / 256.0 - 0.5))
    tree = tq.qtree_to_device(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jtree)), static,
        "cpu")
    x = preprocess_crops_u8(torch.from_numpy(imgs))
    with torch.no_grad():
        got = tq.quant_apply(static, tree, x)
        via_kernel_route = tq.quant_apply(static, tree, x, "kernel")
    assert got.shape == (6, 2, SIZE // 8, SIZE // 8,
                         {"facenet": 71, "handnet": 22}[arch])
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(via_kernel_route, got)


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_quantized_detector_matches_jax(pairs, arch, monkeypatch):
    """``quantize()`` on the same crops builds the JAX detector's tree
    (kernels equal, scales within 1e-5 from the port's own calibration);
    fed JAX's ranges, the trees are equal and the two quantized hand
    detectors give the same keypoints (the JAX one run op by op)."""
    from tpupose.detectors import FaceDetector as JaxFaceDetector
    from tpupose.detectors import HandDetector as JaxHandDetector
    import tpupose.quant as jq
    from tpupose_torch.detectors import crop_keypoints

    jdet0, tdet0 = pairs[arch]
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(jdet0.variables))
    jcls = {"facenet": JaxFaceDetector, "handnet": JaxHandDetector}[arch]
    crops = _crops(5, n=2)
    calib = [crops[0], crops[1][:, ::-1]]

    seen = {}
    jax_calibrate = jq.calibrate_ranges

    def keep_ranges(*args, **kwargs):
        seen["ranges"] = jax_calibrate(*args, **kwargs)
        return seen["ranges"]

    monkeypatch.setattr(jq, "calibrate_ranges", keep_ranges)
    jdet = jcls(arch, cfg=jdet0.cfg, params=params)
    jdet.quantize(calib)
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax.device_get(jdet.variables))

    cls, cfg = PORT[arch]
    own = cls(cfg=cfg, params=params, device="cpu")
    own.quantize(calib)
    assert own.conv7_impl == "im2col"
    for path, ref in jtree["qlayers"].items():
        got = own.qtree["qlayers"][path]
        for a, b in zip(got["kernel_q"], ref["kernel_q"]):
            np.testing.assert_array_equal(a, b, err_msg=path)
        for a, b in zip(got["mult"], ref["mult"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=path)

    monkeypatch.setattr(crop_keypoints, "calibrate_ranges",
                        lambda model, frames: seen["ranges"])
    det = cls(cfg=cfg, params=params, device="cpu")
    det.quantize(calib)
    for path, ref in jtree["qlayers"].items():
        np.testing.assert_array_equal(det.qtree["qlayers"][path]["bias_eff"],
                                      ref["bias_eff"], err_msg=path)
    if arch == "handnet":
        # JAX op by op takes ~11 s here; FaceNet's int8 maps are held by
        # test_int8_crop_forward_equals_jax_op_by_op instead
        flips = [False, True]
        with jax.disable_jit():
            ref = jdet.detect_crops(crops, flips)
        n_valid = _assert_keypoints_equal(det.detect_crops(crops, flips),
                                          ref)
        assert n_valid > 0
    with pytest.raises(ValueError, match="already quantized"):
        det.quantize(calib)


@pytest.mark.parametrize("conv7_impl, error", [
    ("kernel", "CUDA kernel"), ("xla", "no int8 convolution"),
    ("pallas", "unknown conv7_impl")])
def test_crop_quantize_rejects_routes_a_cpu_detector_cannot_run(
        pairs, conv7_impl, error):
    _, tdet = pairs["handnet"]
    with pytest.raises(ValueError, match=error):
        tdet.quantize(_crops(6), conv7_impl=conv7_impl)
    assert not tdet.quantized


def test_crop_detector_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (FaceDetector, HandDetector):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg=PORT["handnet"][1])


# ------------------------------------------------------------ the cascade


@pytest.fixture(scope="module")
def scene():
    """A 92x124 frame and two persons' poses in it: faces, both hands of
    the first, the right hand of the second (its left wrist missing), one
    hand crop running off the frame."""
    img = np.random.RandomState(0).randint(0, 255, (92, 124, 3),
                                           dtype=np.uint8)
    joints = {0: (30, 20), 1: (30, 31), 2: (22, 31), 3: (18, 43),
              4: (15, 55), 5: (38, 31), 6: (42, 43), 7: (45, 55),
              8: (25, 60), 11: (35, 60), 14: (27, 18), 15: (33, 18),
              16: (24, 19), 17: (36, 19)}
    poses = np.zeros((2, 18, 3))
    for j, (x, y) in joints.items():
        poses[0, j] = (x, y, 2)
        poses[1, j] = (x + 62, y + 8, 2)
    poses[1, 7] = 0
    poses[1, 4, :2] = (118, 70)
    return img, poses, np.array([1.0, 0.8])


class _FixedPoses:
    """A pose detector that returns the same table for every frame."""

    def __init__(self, poses, scores):
        self.table = (poses, scores)

    def __call__(self, img):
        return self.table


def test_cascade_results_match_jax(pairs, scene):
    """The same poses through both cascades: the same face and hand crops,
    keypoints and boxes; the port's drawing is JAX's pixel for pixel."""
    from tpupose.apps.demo import run_cascade as jax_run_cascade
    from tpupose_torch.apps.demo import cascade_results, run_cascade

    img, poses, scores = scene
    pose = _FixedPoses(poses, scores)
    jface, tface = pairs["facenet"]
    jhand, thand = pairs["handnet"]
    ref_img, ref = jax_run_cascade(img, pose, jface, jhand)
    got = cascade_results(img, pose, tface, thand)
    assert got["poses"] is poses and got["scores"] is scores
    assert len(got["faces"]) == len(ref["faces"]) >= 1
    assert len(got["hands"]) == len(ref["hands"]) >= 1
    for (gk, gb), (rk, rb) in zip(got["faces"], ref["faces"]):
        assert gb == rb
        _assert_keypoints_equal([gk], [rk])
    for (gs, gk, gb), (rs, rk, rb) in zip(got["hands"], ref["hands"]):
        assert (gs, gb) == (rs, rb)
        _assert_keypoints_equal([gk], [rk])
    res_img, results = run_cascade(img, pose, tface, thand)
    np.testing.assert_array_equal(res_img, ref_img)
    assert len(results["faces"]) == len(got["faces"])


class _StubPoseNet(torch.nn.Module):
    """Stands in for CocoPoseNet in a port ``PoseDetector``: the rendered
    scene's maps resized to the input's stride-8 grid, six stages."""

    def __init__(self, pafs, heatmaps):
        super().__init__()
        self.pafs = torch.from_numpy(np.transpose(pafs, (1, 2, 0)))[None]
        self.heatmaps = torch.from_numpy(np.transpose(heatmaps,
                                                      (1, 2, 0)))[None]

    def forward(self, x):
        from tpupose_torch.ops.resize import resize_hw

        b, h, w = x.shape[0], x.shape[1] // 8, x.shape[2] // 8
        maps = [resize_hw(m, (h, w)).expand(b, h, w, m.shape[-1])
                for m in (self.pafs, self.heatmaps)]
        return tuple(m[None].expand(6, *m.shape) for m in maps)


def test_cascade_results_on_a_stubbed_pose_detector(pairs):
    """The port's own ``PoseDetector`` (its network stubbed by rendered
    maps) in front of the crop detectors, as the JAX test suite drives
    its demo."""
    from test_postprocess import _render_scene
    from tpupose_torch.apps.demo import cascade_results
    from tpupose_torch.config import InferenceConfig
    from tpupose_torch.detectors import PoseDetector

    pafs, heatmaps = _render_scene(np.random.RandomState(3), n_people=2,
                                   hw=(46, 62))
    det = PoseDetector(cfg=InferenceConfig(img_size=64, heatmap_size=64,
                                           max_peaks_per_joint=8,
                                           max_subsets=16),
                       device="cpu", seed=0)
    det.model = _StubPoseNet(pafs, heatmaps)
    img = np.random.RandomState(0).randint(0, 255, (92, 124, 3),
                                           dtype=np.uint8)
    calls = []
    results = cascade_results(img, det, pairs["facenet"][1],
                              pairs["handnet"][1],
                              on_crops=lambda f, h: calls.append(
                                  (len(f), len(h))))
    assert len(results["poses"]) >= 1
    assert calls == [(len(results["faces"]), len(results["hands"]))]
    assert len(results["faces"]) + len(results["hands"]) >= 1
    for side, keypoints, bbox in results["hands"]:
        assert side in ("left", "right") and len(keypoints) == 21
        assert len(bbox) == 4


def test_draw_matches_jax():
    from tpupose.detectors import draw as jdraw
    from tpupose_torch.detectors import draw as tdraw

    rng = np.random.RandomState(12)
    img = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    poses = np.zeros((2, 18, 3))
    poses[:, :, 0] = rng.uniform(5, 75, (2, 18))
    poses[:, :, 1] = rng.uniform(5, 55, (2, 18))
    poses[:, :, 2] = 2 * (rng.rand(2, 18) < 0.8)
    face = [[int(rng.randint(60)), int(rng.randint(40)), 0.5]
            if rng.rand() < 0.7 else None for _ in range(70)]
    hand = [[int(rng.randint(60)), int(rng.randint(40)), 0.5]
            if rng.rand() < 0.7 else None for _ in range(21)]
    for name, args in (("draw_person_pose", (poses,)),
                       ("draw_person_pose", (np.empty((0, 18, 3)),)),
                       ("draw_face_keypoints", (face, (3, 5))),
                       ("draw_hand_keypoints", (hand, (7, 2)))):
        got = getattr(tdraw, name)(img, *args)
        np.testing.assert_array_equal(got, getattr(jdraw, name)(img, *args),
                                      err_msg=name)
