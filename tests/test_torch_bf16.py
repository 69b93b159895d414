"""bfloat16 compute in the port's detectors, bundles and demo, on the CPU.

The JAX package's ``compute_dtype=jnp.bfloat16`` detectors are the
reference: the same calibrated seeded weights (the port's, as
``tests/test_torch_serving.py``), cast to bfloat16 at rest on both sides.
CocoPoseNet runs its 6 stages at ``img_size=96``, FaceNet at 64.

Tolerances: bfloat16 maps within 5e-2 x max|ref| of JAX's at every pixel
and 5e-3 x max|ref| in rms.  Both round every layer's output to bfloat16
(8 mantissa bits), in other summation orders, and a rounding that flips
one way on one side spreads through 40 layers: at these seeds the port's
PAFs sit up to 2.9e-2 (rms 3.5e-3) from JAX's, while each package's
bfloat16 PAFs sit up to 3.4e-2 (port) and 4.2e-2 (JAX) from the float32
ones.  The float32 route is bit-equal to the plain ``CocoPoseNet``
forward; a bfloat16 bundle's pose tables are exactly the live bfloat16
detector's.
"""

import dataclasses
import json
import os
import shutil

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import FaceConfig as JaxFaceConfig
from tpupose.config import InferenceConfig as JaxInferenceConfig
from tpupose_torch import quant as tq
from tpupose_torch.config import FaceConfig, InferenceConfig
from tpupose_torch.detectors import FaceDetector
from tpupose_torch.detectors.pose import (PoseDetector, float32_numerics,
                                          preprocess_u8)
from tpupose_torch.models import CocoPoseNet
from tpupose_torch.ops.resize import resize_u8_linear
from tpupose_torch.serving import ServingPoseDetector, save_bundle
from tpupose_torch.utils.calibrate import (calibrate_crop_output_conv,
                                           calibrate_output_convs)

KW = dict(img_size=96, heatmap_size=88, max_subsets=128,
          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
CFG = InferenceConfig(**KW)
BF16_TOL = 5e-2       # max abs error / max|ref|
BF16_RMS = 5e-3       # rms error / max|ref|


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
def tmp_path(tmp_path):
    """A test's directory, removed when it ends: a full-width bundle's
    params.npz is ~200 MB, and pytest keeps every test's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def params():
    """The port's seeded weights, calibrated so the maps carry peaks, as
    a Flax tree (``tests/test_torch_serving.py``'s way: no Flax init)."""
    det = PoseDetector(cfg=CFG, device="cpu")
    assert calibrate_output_convs(det, _frame())
    return det.host_weights()


@pytest.fixture(scope="module")
def bf16_pair(params):
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    return (JaxPoseDetector("posenet", cfg=JaxInferenceConfig(**KW),
                            params=params, compute_dtype=jnp.bfloat16),
            PoseDetector(params=params, cfg=CFG, device="cpu",
                         compute_dtype=torch.bfloat16))


def _assert_close(got, ref, tol=BF16_TOL, rms=BF16_RMS):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * scale)
    assert np.sqrt(((got.numpy() - ref) ** 2).mean()) <= rms * scale


def test_bf16_parameters_are_stored_in_bf16(bf16_pair):
    jdet, tdet = bf16_pair
    assert {p.dtype for p in tdet.model.parameters()} == {torch.bfloat16}
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(
        jdet.variables)} == {jnp.dtype(jnp.bfloat16)}
    # the host tree stays float32 (npz holds no bfloat16), bf16 values
    kernel = tdet.host_weights()["params"]["stem"]["conv1_1"]["conv"][
        "kernel"]
    assert kernel.dtype == np.float32
    np.testing.assert_array_equal(
        kernel, np.asarray(jdet.variables["params"]["stem"]["conv1_1"]
                           ["conv"]["kernel"], np.float32))


@pytest.mark.parametrize("seed", [0, 2])
def test_bf16_pose_maps_match_jax(bf16_pair, seed):
    jdet, tdet = bf16_pair
    (jpaf, jhm), jscale = jdet.compute_maps(_frame(seed))
    (tpaf, thm), tscale = tdet.compute_maps(_frame(seed))
    assert tscale == jscale
    _assert_close(tpaf, jpaf)
    _assert_close(thm, jhm)


def test_bf16_precise_maps_match_jax(params):
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    two = dict(KW, scales=(0.5, 1.0))
    jdet = JaxPoseDetector("posenet", cfg=JaxInferenceConfig(**two),
                           params=params, precise=True,
                           compute_dtype=jnp.bfloat16)
    tdet = PoseDetector(params=params, cfg=InferenceConfig(**two),
                        precise=True, device="cpu",
                        compute_dtype=torch.bfloat16)
    (jpaf, jhm), _ = jdet.compute_maps(_frame(1))
    (tpaf, thm), _ = tdet.compute_maps(_frame(1))
    _assert_close(tpaf, jpaf)
    _assert_close(thm, jhm)


def test_f32_route_is_the_plain_forward(params):
    """A float32 detector's maps are the plain ``CocoPoseNet`` forward's,
    bit for bit: the bfloat16 option leaves that route alone."""
    det = PoseDetector(params=params, cfg=CFG, device="cpu")
    assert det.compute_dtype is torch.float32
    assert {p.dtype for p in det.model.parameters()} == {torch.float32}
    plain = CocoPoseNet()
    plain.load_state_dict(det.model.state_dict())
    x = preprocess_u8(torch.from_numpy(_frame(0))[None])
    with float32_numerics(), torch.no_grad():
        got = det._forward(x)
        ref = plain.eval()(x)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_bf16_quantize_calibrates_on_the_bf16_forward(bf16_pair):
    """``quantize()`` on a bfloat16 detector, as the JAX package's: the
    ranges come from the bfloat16 forward, the int8 tree from the
    bfloat16 weights read as float32, and the int8 maps are float32."""
    jdet, bdet = bf16_pair
    det = PoseDetector(cfg=CFG, device="cpu", compute_dtype=torch.bfloat16)
    det.model.load_state_dict(bdet.model.state_dict())
    frames = [_frame(0), _frame(0)[:, ::-1]]
    det.quantize(frames)
    x = preprocess_u8(torch.from_numpy(np.stack(
        [resize_u8_linear(f, (96, 96)) for f in frames])))
    with float32_numerics():
        ranges = tq.calibrate_ranges(det.model, x)
    ref_tree, _ = tq.quantize("posenet", det.model, ranges)
    for path, spec in det.qtree["qlayers"].items():
        ref = ref_tree["qlayers"][path]
        for a, b in zip((*spec["kernel_q"], *spec["mult"], spec["bias_eff"]),
                        (*ref["kernel_q"], *ref["mult"], ref["bias_eff"])):
            np.testing.assert_array_equal(a, b)
    from tpupose.quant import calibrate_ranges as jax_calibrate

    jranges = jax_calibrate(jdet.model, jdet.variables,
                            jnp.asarray(x.numpy()))
    for path in ("stem/conv1_1", "stem/conv4_4_CPM", "stage6_L2"):
        assert ranges[path] == pytest.approx(jranges[path], rel=BF16_TOL)
    pafs, hms = det._quant_forward(
        preprocess_u8(torch.from_numpy(_frame(0))[None]))
    assert pafs.dtype == hms.dtype == torch.float32
    assert torch.isfinite(hms).all() and hms.abs().max() > 0


def test_bf16_face_maps_match_jax():
    from tpupose.detectors import FaceDetector as JaxFaceDetector

    f32 = FaceDetector(cfg=FaceConfig(img_size=64), device="cpu", seed=5)
    crops = [np.random.RandomState(i).randint(0, 256, (48, 40, 3)).astype(
        np.uint8) for i in range(2)]
    calibrate_crop_output_conv(f32, crops)
    params = {"params": tq.model_params(f32.model)}
    jdet = JaxFaceDetector("facenet", cfg=JaxFaceConfig(img_size=64),
                           params=params, compute_dtype=jnp.bfloat16)
    tdet = FaceDetector(cfg=FaceConfig(img_size=64), params=params,
                        device="cpu", compute_dtype=torch.bfloat16)
    assert {p.dtype for p in tdet.model.parameters()} == {torch.bfloat16}
    imgs = tdet.prepare_crops(crops, [False, True])
    ref = jdet.model.apply(jdet.variables,
                           jnp.asarray(imgs, jnp.float32) / 256.0 - 0.5)
    _assert_close(tdet.forward_maps(imgs), ref)
    assert len(tdet.detect_crops(crops, [False, True])) == 2


def test_bf16_bundle_round_trip(bf16_pair, tmp_path):
    """A bfloat16 bundle records ``params_dtype="bfloat16"``, stores float32
    in ``params.npz``, reloads the weights as bfloat16, and serves the
    live bfloat16 detector's tables."""
    _, tdet = bf16_pair
    path = str(tmp_path / "bf16")
    save_bundle(tdet, path, [(96, 128)], platforms=("cpu",))
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["params_dtype"] == "bfloat16"
    with np.load(os.path.join(path, "params.npz")) as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    srv = ServingPoseDetector(path, device="cpu")
    assert {w.dtype for w in srv.weights} == {torch.bfloat16}
    for seed in (0, 3):
        got, ref = srv(_frame(seed)), tdet(_frame(seed))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_mixed_dtype_params_rejected(params, tmp_path):
    """As ``tests/test_serving.py``'s case: a tree mixing float dtypes
    cannot be rebuilt from one recorded params_dtype, so export refuses
    it."""
    det = PoseDetector(params=params, cfg=CFG, device="cpu",
                       compute_dtype=torch.bfloat16)
    det.model.stage1_L1.conv5_1_CPM_L1.conv.float()
    with pytest.raises(ValueError, match="mixes float dtypes"):
        save_bundle(det, str(tmp_path / "b"), [(96, 128)],
                    platforms=("cpu",))
    assert not os.path.exists(tmp_path / "b")


def test_demo_bf16_and_conv_nms_on_cpu(tmp_path, monkeypatch):
    """``apps/demo.py --bf16 --nms-mode conv`` builds all three detectors
    in bfloat16 with the conv NMS mode and runs the cascade (nets shrunk
    to 64 px for the CPU)."""
    import tpupose_torch.detectors as detectors
    from tpupose_torch.apps import demo
    from tpupose_torch.config import HandConfig

    built = {}

    def small(cls, default_cfg, **cfg_kw):
        class Small(cls):
            def __init__(self, *args, **kw):
                kw["cfg"] = dataclasses.replace(kw.get("cfg", default_cfg),
                                                **cfg_kw)
                super().__init__(*args, **kw)
                built[cls.__name__] = self
        return Small

    monkeypatch.setattr(detectors, "PoseDetector", small(
        PoseDetector, InferenceConfig(), img_size=64, heatmap_size=64))
    monkeypatch.setattr(detectors, "FaceDetector",
                        small(FaceDetector, FaceConfig(), img_size=64))
    monkeypatch.setattr(detectors, "HandDetector", small(
        detectors.HandDetector, HandConfig(), img_size=64))
    img = str(tmp_path / "in.png")
    out = str(tmp_path / "out.png")
    cv2.imwrite(img, _frame(4, (60, 80)))
    demo.main(["--img", img, "--out", out, "--device", "cpu", "--bf16",
               "--nms-mode", "conv"])
    assert cv2.imread(out).shape == (60, 80, 3)
    assert built["PoseDetector"].cfg.nms_mode == "conv"
    assert isinstance(built["HandDetector"].cfg, HandConfig)
    for det in built.values():
        assert det.compute_dtype is torch.bfloat16
        assert {p.dtype for p in det.model.parameters()} == {torch.bfloat16}
