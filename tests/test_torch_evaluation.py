"""The port's COCO keypoint-AP harness on the CPU: ``evaluation.py`` (a
copy of the JAX package's), ``apps/evaluate.py`` and the native RLE
decoder of ``native/``.

The evaluator's metrics must equal ``tpupose.evaluation``'s exactly and
``tests/cocoeval_reference.py``'s within 1e-9 (its own tests' bound), on
the fixtures of ``tests/test_eval_apps.py``.  ``evaluate_detector`` runs
over a tiny COCO folder written here (PNG frames, person keypoints, a
crowd region); both packages' detectors run a stub net that renders the
same scene (as ``tests/test_eval_apps.py``'s ``_StubModel``), so their
pose tables agree within 1e-4 and the metrics are equal.  Native RLE
masks equal the numpy decoder's and ``tpupose.native``'s bit for bit.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import test_eval_apps as jev
from cocoeval_reference import evaluate_and_summarize
from test_native import _leb_encode, _mask_to_counts
from tpupose import evaluation as jeval
from tpupose_torch import evaluation as teval
from tpupose_torch import native
from tpupose_torch.config import InferenceConfig
from tpupose_torch.data import coco_json
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops.resize import resize_hw

FRAME_HW = (92, 124)
N_IMAGES = 5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ evaluator


def _summaries(images):
    port, ref = teval.KeypointEvaluator(), jeval.KeypointEvaluator()
    for dts, gts in images:
        port.add_image([dict(d) for d in dts], [dict(g) for g in gts])
        ref.add_image([dict(d) for d in dts], [dict(g) for g in gts])
    return port.summarize(), ref.summarize()


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_evaluator_equals_jax_and_the_transcription(seed):
    rng = np.random.RandomState(seed)
    images = jev.TestEvaluatorVsIndependentTranscription()._random_images(
        rng, n_images=rng.randint(2, 6))
    got, ref = _summaries(images)
    assert got == ref
    cocoeval = evaluate_and_summarize(images)
    for key in ("AP", "AP50", "AP75", "AP_medium", "AP_large", "AR"):
        assert got[key] == pytest.approx(cocoeval[key], abs=1e-9), key


def test_evaluator_hand_derived_fixture():
    got, ref = _summaries(jev.TestHandDerivedAPFixture()._scenario())
    assert got == ref
    assert got["AP"] == pytest.approx(0.5 + 25.5 / 101, abs=1e-9)
    assert got["AP75"] == pytest.approx(51 / 101, abs=1e-9)
    assert got["AP_large"] == -1.0


def test_evaluator_crowd_and_area_rules_equal_jax():
    """The crowd re-match and out-of-range ignore cases of
    ``tests/test_eval_apps.py``, and empty images with hallucinations."""
    rng = np.random.RandomState(10)
    k = jev._random_kpts17(rng, lo=60, hi=140)
    crowd = {"keypoints": [0.0] * 51, "num_keypoints": 0, "area": 10000.0,
             "bbox": [400, 400, 100, 100], "iscrowd": 1}
    good = {"keypoints": [float(v) for row in k for v in row],
            "score": 0.9, "area": 6000.0}
    in_crowd = [{"keypoints": [float(v) for v in np.full(
        (17, 3), 420.0 + 10 * i).reshape(-1)], "score": 0.8 - 0.1 * i,
        "area": 5000.0} for i in range(2)]
    k_med = jev._random_kpts17(rng, lo=100, hi=150)
    k_large = jev._random_kpts17(rng, lo=400, hi=520)
    med = [{"keypoints": [float(v) for row in k_med for v in row],
            "score": 0.9, "area": 2500.0},
           {"keypoints": [float(v) for row in k_large for v in row],
            "score": 0.95, "area": float(120 * 120)}]
    fp = {"keypoints": [float(v) for v in
                        jev._random_kpts17(rng).reshape(-1)],
          "score": 0.99, "area": 3000.0}
    images = [([good] + in_crowd, [jev._gt_from_pose17(k), crowd]),
              (med, [jev._gt_from_pose17(k_med, area=2500.0)]),
              ([fp], []), ([], [])]
    got, ref = _summaries(images)
    assert got == ref
    e = teval._evaluate_image(med, [jev._gt_from_pose17(k_med, area=2500.0)],
                              teval.AREA_RANGES["medium"])
    assert teval._accumulate([e])["AP"] == pytest.approx(1.0)


def test_result_conversion_equals_jax():
    rng = np.random.RandomState(4)
    poses = rng.uniform(0, 200, (3, 18, 3))
    poses[:, :, 2] = (rng.rand(3, 18) < 0.7) * 2.0
    poses[poses[:, :, 2] == 0, :2] = 0.0
    scores = rng.rand(3)
    got = teval.poses_to_results(poses, scores, 7)
    assert got == jeval.poses_to_results(poses, scores, 7)
    for pose in poses:
        np.testing.assert_array_equal(teval.pose18_to_coco17(pose),
                                      jeval.pose18_to_coco17(pose))
    gt = jev._gt_from_pose17(jeval.pose18_to_coco17(poses[0]))
    dt = teval.pose18_to_coco17(poses[1])
    assert teval.compute_oks(dt, gt) == jeval.compute_oks(dt, gt)
    np.testing.assert_array_equal(teval.KPT_SIGMAS, jeval.KPT_SIGMAS)


# ------------------------------------------------------- evaluate app


class _StubPoseNet(torch.nn.Module):
    """The port's twin of ``tests/test_eval_apps.py``'s ``_StubModel``:
    the rendered scene's maps resized (half-pixel linear) to the input's
    stride-8 grid, heatmaps scaled by 1 + 0.1 x each frame's mean, six
    stages."""

    def __init__(self, pafs, heatmaps):
        super().__init__()
        self.pafs = torch.from_numpy(np.transpose(pafs, (1, 2, 0)))[None]
        self.heatmaps = torch.from_numpy(np.transpose(heatmaps,
                                                      (1, 2, 0)))[None]

    def forward(self, x):
        b, h, w = x.shape[0], x.shape[1] // 8, x.shape[2] // 8
        amp = 1.0 + 0.1 * x.reshape(b, -1).mean(dim=1)[:, None, None, None]
        paf, hm = (resize_hw(m, (h, w)).expand(b, h, w, m.shape[-1])
                   for m in (self.pafs, self.heatmaps))
        return (paf[None].expand(6, *paf.shape),
                (hm * amp)[None].expand(6, *hm.shape))


def _detectors():
    """(JAX, port) pose detectors on the same stubbed scene."""
    from test_postprocess import _render_scene

    jdet = jev._stub_pose_detector()
    pafs, heatmaps = _render_scene(np.random.RandomState(3), n_people=2,
                                   hw=(46, 62))
    tdet = PoseDetector(cfg=InferenceConfig(**{
        k: getattr(jev.SMALL_CFG, k) for k in (
            "img_size", "heatmap_size", "max_peaks_per_joint",
            "max_subsets")}), device="cpu")
    tdet.model = _StubPoseNet(pafs, heatmaps)
    return jdet, tdet


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A val2017-style folder: PNG frames, person keypoints built from the
    stub scene's detections (shifted a few pixels, so OKS < 1), an
    unmatched person, a crowd region with an RLE mask and an empty
    image."""
    root = tmp_path_factory.mktemp("coco")
    os.makedirs(root / "val2017")
    os.makedirs(root / "annotations")
    jdet, _ = _detectors()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(N_IMAGES):
        img = rng.randint(0, 256, FRAME_HW + (3,)).astype(np.uint8)
        name = f"{i:012d}.png"
        cv2.imwrite(str(root / "val2017" / name), img)
        images.append({"id": i + 1, "file_name": name,
                       "height": FRAME_HW[0], "width": FRAME_HW[1]})
        if i == N_IMAGES - 1:
            continue                         # a person-free image
        poses, _ = jdet(img)
        for pose in poses[:1 + i % 2]:
            k = jeval.pose18_to_coco17(pose)
            k[:, :2] += rng.uniform(-3, 3, (17, 2)) * (k[:, 2:] > 0)
            anns.append(dict(jev._gt_from_pose17(k), image_id=i + 1,
                             category_id=1, id=len(anns) + 1))
        if i == 1:
            k = jev._random_kpts17(rng, 5, 80)
            anns.append(dict(jev._gt_from_pose17(k), image_id=i + 1,
                             category_id=1, id=len(anns) + 1))
        if i == 2:
            mask = np.zeros(FRAME_HW, np.uint8)
            mask[50:80, 90:120] = 1
            anns.append({"image_id": i + 1, "category_id": 1,
                         "id": len(anns) + 1, "iscrowd": 1,
                         "num_keypoints": 0, "keypoints": [0] * 51,
                         "area": 900.0, "bbox": [90, 50, 30, 30],
                         "segmentation": {
                             "counts": _leb_encode(_mask_to_counts(mask)),
                             "size": list(FRAME_HW)}})
    with open(root / "annotations" / "person_keypoints_val2017.json",
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return str(root)


def _datasets(coco_dir):
    from tpupose.data import CocoPoseDataset as JaxCocoPoseDataset
    from tpupose_torch.data import CocoPoseDataset

    ann = os.path.join(coco_dir, "annotations",
                       "person_keypoints_val2017.json")
    img_dir = os.path.join(coco_dir, "val2017")
    return (JaxCocoPoseDataset(ann, img_dir, mode="eval"),
            CocoPoseDataset(ann, img_dir, mode="eval"))


def test_evaluate_detector_equals_jax(coco_dir):
    from tpupose.apps.evaluate import evaluate_detector as jax_evaluate
    from tpupose_torch.apps.evaluate import evaluate_detector

    jdet, tdet = _detectors()
    jds, tds = _datasets(coco_dir)
    ref, ref_results = jax_evaluate(jdet, jds, verbose=False)
    runs = [evaluate_detector(tdet, tds, verbose=False, pipeline_depth=d)
            for d in (2, 0)]
    for metrics, results in runs:
        assert metrics.keys() == ref.keys()
        for key in ref:
            if key != "seconds_per_image":
                assert metrics[key] == ref[key], key
        assert len(results) == len(ref_results)
        for got, want in zip(results, ref_results):
            assert got["image_id"] == want["image_id"]
            np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                                       atol=1e-4)
            assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert 0.0 < ref["AP"] < 1.0 and ref["images"] == N_IMAGES


def test_ground_truth_fed_back_scores_ap_one(coco_dir):
    """GT keypoints returned as detections score AP 1.0."""
    from tpupose_torch.apps.evaluate import evaluate_detector

    _, tds = _datasets(coco_dir)

    class _Oracle:
        def __call__(self, img):
            return self.poses, self.scores

    oracle = _Oracle()

    class _Dataset:
        def __len__(self):
            return len(tds)

        def eval_sample(self, i):
            img, gts, img_id = tds.eval_sample(i)
            people = [g for g in gts if not g.get("iscrowd")]
            poses = np.zeros((len(people), 18, 3))
            for n, g in enumerate(people):
                k = np.asarray(g["keypoints"], np.float64).reshape(17, 3)
                for c, joint in enumerate(teval.COCO_JOINT_ORDER):
                    poses[n, joint] = k[c]
            oracle.poses, oracle.scores = poses, np.linspace(
                0.9, 0.5, len(people))
            return img, gts, img_id

    metrics, _ = evaluate_detector(oracle, _Dataset(), verbose=False,
                                   pipeline_depth=0)
    assert metrics["AP"] == pytest.approx(1.0)


@pytest.fixture
def small_detector(monkeypatch):
    """``main`` builds ``PoseDetector("posenet", ...)``; swap in the 64-px
    net, seeded and calibrated so its maps carry peaks, and record it."""
    import tpupose_torch.detectors as detectors
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    built = []

    class Small(PoseDetector):
        def __init__(self, arch, weights_file=None, precise=False,
                     device="cuda"):
            super().__init__(arch, cfg=InferenceConfig(
                img_size=64, heatmap_size=64, max_peaks_per_joint=8,
                max_subsets=16), device=device)
            calibrate_output_convs(self, np.random.RandomState(1).randint(
                0, 256, FRAME_HW + (3,)).astype(np.uint8))
            built.append(self)

    monkeypatch.setattr(detectors, "PoseDetector", Small)
    return built


@pytest.mark.parametrize("flags", [["--bucketed", "--canvas_long", "128"],
                                   ["--quant"]], ids=["bucketed", "quant"])
def test_main_runs_on_a_coco_folder(coco_dir, small_detector, tmp_path,
                                    flags):
    from tpupose_torch.apps.evaluate import main

    out = str(tmp_path / "eval.json")
    metrics = main(["--coco_dir", coco_dir, "--device", "cpu", "--out", out,
                    *flags])
    with open(out) as f:
        written = json.load(f)
    assert written["metrics"] == metrics
    assert metrics["images"] == N_IMAGES and "AP" in metrics
    det, = small_detector
    assert det.quantized == ("--quant" in flags)
    if det.quantized:
        assert det.conv7_impl == "im2col"


# ------------------------------------------------------------ native RLE


def test_native_counts_equal_numpy_and_jax():
    from tpupose.native import rle_counts_to_mask_native as jax_native

    rng = np.random.RandomState(0)
    for _ in range(3):
        h, w = rng.randint(5, 80, 2)
        mask = (rng.rand(h, w) < 0.3).astype(np.uint8)
        counts = _mask_to_counts(mask)
        got = native.rle_counts_to_mask_native(counts, h, w)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(
            got, coco_json.rle_counts_to_mask_numpy(counts, h, w))
        np.testing.assert_array_equal(got, jax_native(counts, h, w))


def test_native_compressed_string_equals_numpy_and_jax():
    from tpupose.native import rle_decode_native as jax_native

    rng = np.random.RandomState(1)
    for h, w in ((37, 53), (1, 1), (64, 3)):
        mask = (rng.rand(h, w) < 0.25).astype(np.uint8)
        s = _leb_encode(_mask_to_counts(mask))
        got = coco_json.decode_compressed_rle(s, h, w)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(
            got, coco_json.decode_compressed_rle_numpy(s, h, w))
        np.testing.assert_array_equal(got, jax_native(s, h, w))


def test_ann_to_mask_rle_equals_jax():
    from tpupose.data import coco_json as jcoco

    rng = np.random.RandomState(2)
    mask = (rng.rand(30, 40) < 0.4).astype(np.uint8)
    counts = _mask_to_counts(mask)
    for seg in ({"counts": _leb_encode(counts), "size": [30, 40]},
                {"counts": [int(c) for c in counts], "size": [30, 40]}):
        ann = {"segmentation": seg}
        got = coco_json.ann_to_mask(ann, 30, 40)
        np.testing.assert_array_equal(got, jcoco.ann_to_mask(ann, 30, 40))
        np.testing.assert_array_equal(got, mask)


def test_native_malformed_input_raises():
    with pytest.raises(ValueError, match="malformed"):
        native.rle_decode_native(chr(0x20 + 48), 4, 4)
    with pytest.raises(ValueError, match="do not fit"):
        native.rle_counts_to_mask_native([100], 4, 4)
    with pytest.raises(ValueError, match="ASCII"):
        native.rle_decode_native("é", 4, 4)


def test_native_build_failure_is_loud(tmp_path, monkeypatch):
    """A source g++ rejects raises with the compiler's message; nothing
    decodes in Python instead."""
    bad = tmp_path / "maskops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.load_maskops()
    assert not os.listdir(tmp_path / "build")
