"""Serving bundles of the port (``tpupose_torch/serving.py``) on the CPU:
exported with ``torch.export``, loaded, and held to the live port detector
and to the JAX package.

Both packages run the full 6-stage CocoPoseNet at ``img_size=96`` on the
same seeded random params, calibrated by the port's copy of
``calibrate_output_convs`` so the maps carry peaks, with the subset filter
relaxed as in ``tests/test_golden_parity.py``; the precise pyramid runs
two of its scales, FaceNet runs at ``img_size=64``.  The fast and int8
bundles are exported once per module.

Tolerances: a bundle's pose tables, batched results and crop keypoints are
exactly the live port detector's (the same bodies, ops and weights); pose
tables against JAX's live detector within ``_assert_pose_tables_match``'s
5e-3 (float32 maps in other summation orders); maps from a JAX-written
``params.npz`` within 1e-4 x max|ref| of JAX's, as in
``tests/test_torch_detector.py``.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig as JaxInferenceConfig
from tpupose_torch import quant as tq
from tpupose_torch import serving
from tpupose_torch.config import FaceConfig, InferenceConfig
from tpupose_torch.detectors import FaceDetector
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.serving import (ServingCropDetector, ServingPoseDetector,
                                   save_bundle, save_crop_bundle)
from tpupose_torch.utils.calibrate import (calibrate_crop_output_conv,
                                           calibrate_output_convs)

from test_torch_detector import _assert_pose_tables_match

KW = dict(img_size=96, heatmap_size=88, max_subsets=128,
          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
CFG = InferenceConfig(**KW)
HW = (96, 128)


def _frame(seed):
    return np.random.RandomState(seed).randint(0, 256, (*HW, 3)).astype(
        np.uint8)


def _same(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
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


def pose_detectors():
    """(JAX detector, the Flax params, port detector) on the same
    calibrated params (the JAX detector takes the port's, so no Flax init
    runs)."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector

    det = PoseDetector(cfg=CFG, device="cpu")
    assert calibrate_output_convs(det, _frame(0))
    variables = det.host_weights()
    return (JaxPoseDetector("posenet", params=variables,
                            cfg=JaxInferenceConfig(**KW)), variables, det)


@pytest.fixture(scope="module")
def detectors():
    return pose_detectors()


@pytest.fixture(scope="module")
def fast(detectors, tmp_path_factory):
    _, _, det = detectors
    path = str(tmp_path_factory.mktemp("fast"))
    save_bundle(det, path, [HW], platforms=("cpu",), batch_sizes=(2,))
    yield path, ServingPoseDetector(path, device="cpu")
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def int8(detectors, tmp_path_factory):
    _, variables, _ = detectors
    det = PoseDetector(params=variables, cfg=CFG, device="cpu")
    det.quantize([_frame(0), _frame(0)[:, ::-1]])
    path = str(tmp_path_factory.mktemp("int8"))
    save_bundle(det, path, [HW], platforms=("cpu",))
    yield det, path, ServingPoseDetector(path, device="cpu")
    shutil.rmtree(path, ignore_errors=True)


def test_bundle_layout_keeps_jax_meta_keys(fast, int8):
    path, srv = fast
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert {"arch", "mode", "params_dtype", "cfg", "platforms",
            "geometries"} <= set(meta)
    assert meta["platforms"] == ["cpu"] and meta["params_dtype"] == "float32"
    geom = meta["geometries"]["96x128"]
    assert set(geom) == {"program", "in_hw", "map_hw", "batched"}
    assert set(geom["batched"]) == {"2"}
    assert serving._cfg_from_meta(meta["cfg"]) == CFG
    assert srv.image_sizes == [HW] and srv.batch_sizes(HW) == [2]
    files = sorted(os.listdir(path))
    assert files == ["fast_96x128.cpu.pt2", "fast_96x128_b2.cpu.pt2",
                     "meta.json", "params.npz"]
    _, qpath, qsrv = int8
    with open(os.path.join(qpath, "meta.json")) as f:
        assert json.load(f)["params_dtype"] == "quant-w8a8"
    assert qsrv.quantized and not srv.quantized


def test_qtree_flat_round_trip_matches_jax(int8):
    from tpupose.quant import qtree_from_flat as jax_from_flat
    from tpupose.quant import qtree_to_flat as jax_to_flat

    det, _, _ = int8
    ours, theirs = tq.qtree_to_flat(det.qtree), jax_to_flat(det.qtree)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    back = tq.qtree_from_flat(ours)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax_from_flat(theirs))
    spec = back["qlayers"]["stem/conv1_1"]
    assert isinstance(spec["kernel_q"], tuple)
    np.testing.assert_array_equal(spec["kernel_q"][0],
                                  det.qtree["qlayers"]["stem/conv1_1"]
                                  ["kernel_q"][0])
    assert tq.static_from_dict(tq.static_to_dict(det.quant_static)) == \
        det.quant_static


def test_params_npz_keys_match_jax(detectors, tmp_path):
    from tpupose.serving import _save_params as jax_save_params

    _, variables, det = detectors
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert jax_save_params(str(tmp_path / "jax"), variables) == "float32"
    assert serving._save_params(str(tmp_path / "port"),
                                det.host_weights()) == "float32"
    with np.load(tmp_path / "jax" / "params.npz") as j, \
            np.load(tmp_path / "port" / "params.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        assert "stem/conv1_1/conv/kernel" in p.files
        for k in j.files:
            # float32 weights: copied, not computed
            np.testing.assert_array_equal(p[k], j[k])


def test_jax_params_npz_loads_into_port_runner(detectors, tmp_path):
    """A params.npz the JAX package wrote, loaded by the port's loader
    and fed to a port detector with other weights of its own, gives JAX's
    maps."""
    from tpupose.serving import _save_params as jax_save_params

    jdet, variables, _ = detectors
    jax_save_params(str(tmp_path), variables)
    weights = serving.load_params(str(tmp_path), {"params_dtype": "float32"},
                                  "cpu")
    other = PoseDetector(cfg=CFG, device="cpu", seed=7)
    (jpaf, jhm), _ = jdet.compute_maps(_frame(1))
    (in_h, in_w), map_hw = serving._geometry(CFG, *HW)
    assert (in_h, in_w) == HW
    with torch.no_grad():
        paf, hm = other._fast_maps(weights, torch.from_numpy(_frame(1))[None],
                                   map_hw)
    for t, j in ((paf[0], jpaf), (hm[0], jhm)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())


def test_fast_bundle_equals_live_detector(detectors, fast):
    _, _, det = detectors
    _, srv = fast
    for seed in (0, 1):
        ref = det(_frame(seed))
        assert _same(srv(_frame(seed)), ref)
        assert _same(srv.collect(srv.submit(_frame(seed))), ref)
    assert len(ref[0]) >= 1


def test_fast_bundle_batched_equals_live_detect_batch(detectors, fast):
    """B = 2 against the live B = 2 batch; three frames chunk into 2 + a
    chunk padded with its last frame, which equals a live [f, f] batch."""
    _, _, det = detectors
    _, srv = fast
    frames = np.stack([_frame(0), _frame(1), _frame(2)])
    got = srv.detect_batch(frames)
    assert len(got) == 3
    for g, r in zip(got[:2], det.detect_batch(frames[:2])):
        assert _same(g, r)
    assert _same(got[2], det.detect_batch(frames[[2, 2]])[0])
    assert sum(len(p) for p, _ in got) >= 1


def test_fast_bundle_matches_jax_live_detector(detectors, fast):
    jdet, _, _ = detectors
    _, srv = fast
    for seed in (0, 1):
        ref_poses, ref_scores = jdet(_frame(seed))
        poses, scores = srv(_frame(seed))
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)


def test_int8_bundle_equals_live_detector(int8):
    det, _, srv = int8
    for seed in (0, 1):
        ref = det(_frame(seed))
        assert _same(srv(_frame(seed)), ref)
    assert len(ref[0]) >= 1


def test_mixed_precision_bundle_carries_both_trees(detectors, tmp_path):
    """``quantize(min_side=...)`` above the network input keeps the float32
    forward: params.npz holds the int8 tree and the float32 one under
    ``f32|params|...`` (the JAX package's mixed tree), and the bundle's
    tables equal the live detector's."""
    _, variables, _ = detectors
    det = PoseDetector(params=variables, cfg=CFG, device="cpu")
    det.quantize([_frame(0)], min_side=128)
    save_bundle(det, str(tmp_path), [HW], platforms=("cpu",))
    with np.load(tmp_path / "params.npz") as z:
        assert "f32|params|stem|conv1_1|conv|kernel" in z.files
        assert "qlayers|stem/conv1_1|kernel_q|0" in z.files
    srv = ServingPoseDetector(str(tmp_path), device="cpu")
    ref = det(_frame(1))
    assert _same(srv(_frame(1)), ref) and len(ref[0]) >= 1


def test_precise_bundle_equals_live_detect_precise(detectors, tmp_path):
    _, variables, _ = detectors
    det = PoseDetector(params=variables, precise=True, device="cpu",
                       cfg=dataclasses.replace(CFG, scales=(0.5, 1.0)))
    path = str(tmp_path)
    save_bundle(det, path, [HW], platforms=("cpu",))
    srv = ServingPoseDetector(path, device="cpu")
    assert srv.mode == "precise" and len(os.listdir(path)) == 2 + 2 + 1
    ref = det.detect_precise(_frame(0))
    assert _same(srv(_frame(0)), ref) and len(ref[0]) >= 1
    with pytest.raises(ValueError, match="no batched programs"):
        srv.detect_batch(_frame(0)[None])


def test_crop_bundle_equals_live_crop_detector(tmp_path):
    det = FaceDetector(device="cpu", cfg=FaceConfig(img_size=64))
    rng = np.random.RandomState(3)
    crops = [rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
             for _ in range(3)]
    calibrate_crop_output_conv(det, crops)
    save_crop_bundle(det, str(tmp_path), [(40, 36)], batch_sizes=(1, 2),
                     flips=(False, True), platforms=("cpu",))
    srv = ServingCropDetector(str(tmp_path), device="cpu")
    flips = [False, True, False]
    got = srv.detect_crops(crops, flips)
    # three crops chunk over the largest exported batch: 2, then 1 on the
    # B = 1 program; each equals a live batch of the same size (float32
    # convs may sum in another order at another batch size)
    ref = det.detect_crops(crops[:2], flips[:2])
    assert got[:2] == ref
    assert got[2] == det.detect_crop(crops[2])
    assert srv.detect_crop(crops[1], flip=True) == \
        det.detect_crop(crops[1], flip=True)
    assert sum(k is not None for row in ref for k in row) >= 1
    assert srv.crop_sizes == [(40, 36)] and srv.arch == "facenet"
    with pytest.raises(ValueError, match="no tail exported"):
        srv.detect_crops([crops[0][:20]])
    with pytest.raises(ValueError, match="crop-net bundle"):
        ServingPoseDetector(str(tmp_path), device="cpu")


def test_unknown_geometry_and_wrong_runner_raise(fast):
    path, srv = fast
    with pytest.raises(ValueError, match="no program exported"):
        srv(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="not a crop-net bundle"):
        ServingCropDetector(path, device="cpu")
    # weights that are not the program's inputs are refused at load
    load = serving._program_loader(path, "cpu", srv.weights[1:])
    with pytest.raises(ValueError, match="does not match"):
        load("fast_96x128")


def test_bundle_runner_needs_cuda_by_default(fast):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _ = fast
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingPoseDetector(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        save_bundle(None, path, [HW], platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        save_bundle(None, path, [HW], platforms=("tpu",))


def _op_cases(rng):
    """(op name, op arguments, the plain version's result) per op."""
    from tpupose_torch.ops import blur_nms as bn
    from tpupose_torch.ops import conv7 as c7
    from tpupose_torch.ops import conv_s8 as cs
    from tpupose_torch.ops import requant as rq

    def t(a):
        return torch.from_numpy(a)

    hm = t(rng.rand(3, 12, 17).astype(np.float32))
    parts = [t(rng.randint(-128, 128, (1, 5, 6, c)).astype(np.int8))
             for c in (7, 9)]
    kernels = [t(rng.randint(-127, 128, (7, 7, c, 16)).astype(np.int8))
               for c in (7, 9)]
    mults = [t(np.full(16, 1e-3, np.float32))] * 2
    bias = t(rng.randn(16).astype(np.float32))
    x = parts[1]
    k3 = t(rng.randint(-127, 128, (3, 3, 9, 16)).astype(np.int8))
    accs = [t(rng.randint(-9999, 9999, (2, 3, 16)).astype(np.int32))] * 2
    return [
        ("blur_nms", (hm, 2.5, 0.3), bn.blur_nms_reference(hm, 2.5, 0.3)),
        ("conv7_s8", (parts, kernels, mults, bias, True, []),
         c7.conv7_s8_reference(parts, kernels, mults, bias)),
        ("conv_s8", (x, k3, mults[0], bias, False, None),
         cs.conv_s8_reference(x, k3, mults[0], bias, relu=False)),
        ("requant_epilogue", (accs, mults, bias, True, 0.0),
         rq.requant_epilogue_reference(accs, mults, bias, True)),
    ]


@pytest.mark.parametrize("index", range(4), ids=["blur_nms", "conv7_s8",
                                                 "conv_s8", "requant"])
def test_kernel_ops_run_the_plain_versions_on_cpu(index):
    """``tpupose::*`` on CPU tensors: the plain version, uncounted (no
    kernel launched); the fake implementation gives its shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import library  # noqa: F401  registers the ops

    name, args, ref = _op_cases(np.random.RandomState(index))[index]
    op = getattr(torch.ops.tpupose, name)
    got = op(*args)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, r in zip(gots, refs):
        assert torch.equal(g, r)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    fakes = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fakes] == \
        [(r.shape, r.dtype) for r in refs]


def test_traced_routing_is_per_thread():
    import threading

    from tpupose_torch.detectors.portable import portable_programs
    from tpupose_torch.ops import library

    seen = []
    with portable_programs(None):
        assert library.tracing()
        t = threading.Thread(target=lambda: seen.append(library.tracing()))
        t.start()
        t.join()
    assert seen == [False] and not library.tracing()


def test_export_cli_writes_a_servable_crop_bundle(tmp_path):
    """``apps/export_serving.py`` from a Chainer npz: a HandNet bundle at
    ``--img-size 64`` with both flips, equal to the live hand detector
    loaded from the same file."""
    from tpupose_torch.apps import export_serving
    from tpupose_torch.config import HandConfig
    from tpupose_torch.detectors import HandDetector
    from tpupose_torch.models import ARCHS

    model = ARCHS["handnet"](seed=4)
    flat = {}
    for name, conv in model.named_modules():
        if isinstance(conv, torch.nn.Conv2d):
            layer = name.split(".")[-2]
            flat[f"{layer}/W"] = conv.weight.detach().numpy()
            flat[f"{layer}/b"] = conv.bias.detach().numpy()
    npz = str(tmp_path / "handnet.npz")
    np.savez(npz, **flat)
    out = str(tmp_path / "bundle")
    export_serving.main([npz, out, "--arch", "handnet", "--sizes", "40x36",
                         "--batches", "2", "--img-size", "64",
                         "--platforms", "cpu", "--device", "cpu",
                         "--tail-stride", "1"])
    srv = ServingCropDetector(out, device="cpu")
    det = HandDetector(weights_file=npz, device="cpu",
                       cfg=HandConfig(img_size=64))
    rng = np.random.RandomState(5)
    crops = [rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
             for _ in range(2)]
    assert srv.detect_crops(crops, [True, False]) == \
        det.detect_crops(crops, [True, False])
    assert srv.cfg == HandConfig(img_size=64) and srv.tail_stride == 1
