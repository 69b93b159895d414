"""The port's data pipeline (``tpupose_torch.data``: synthetic, loader,
coco_json, augment, dataset) and training reports
(``tpupose_torch.utils.reporting``) against the JAX package's, on the CPU:
bit-equal samples, batches, masks and augmentations, and the same log and
``params.json``."""

import contextlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpupose.config import TrainConfig as JaxTrainConfig
from tpupose.data.augment import augment as jax_augment
from tpupose.data import coco_json as jcoco
from tpupose.data import dataset as jds
from tpupose.data.loader import BatchLoader as JaxBatchLoader
from tpupose.data.synthetic import SyntheticCropDataset as JaxSynthetic
from tpupose.utils import reporting as jrep
from tpupose_torch.config import TrainConfig
from tpupose_torch.data.augment import augment
from tpupose_torch.data import coco_json as tcoco
from tpupose_torch.data import dataset as tds
from tpupose_torch.data.loader import BatchLoader
from tpupose_torch.data.synthetic import SyntheticCropDataset
from tpupose_torch.utils import reporting as trep


@pytest.mark.parametrize("k", [18, 70, 21])
def test_synthetic_samples_equal_jax(k):
    ours = SyntheticCropDataset(k, insize=48, n_samples=5, seed=2)
    ref = JaxSynthetic(k, insize=48, n_samples=5, seed=2)
    assert len(ours) == len(ref)
    for i in range(len(ours)):
        for a, b in zip(ours.sample(i), ref.sample(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_loader_batches_equal_jax(workers):
    """Shuffled, repeating batches (an epoch of 7 samples in batches of 3
    runs across the epoch boundary), inline and from spawned workers."""
    ds = SyntheticCropDataset(18, insize=32, n_samples=7, seed=0)
    ours = BatchLoader(ds, 3, max_persons=2, num_workers=workers, seed=4)
    ref = JaxBatchLoader(JaxSynthetic(18, insize=32, n_samples=7, seed=0),
                         3, max_persons=2, num_workers=workers, seed=4)
    try:
        for got, want in zip([b for _, b in zip(range(4), ours)],
                             [b for _, b in zip(range(4), ref)]):
            for field in ("imgs", "poses", "ignore_mask"):
                g, w = getattr(got, field), getattr(want, field)
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    finally:
        ours.close()
        ref.close()


def test_batch_loader_close_shuts_the_pool_down_mid_delivery():
    """``close()`` while 4 workers deliver 368-px samples, three times
    over, in a subprocess bounded at 240 s: the pool must shut down.
    (``Pool.terminate`` could kill a worker halfway through writing a
    result and leave the pool's result thread waiting forever.)"""
    code = textwrap.dedent("""
        from tpupose_torch.data import BatchLoader, SyntheticCropDataset
        for _ in range(3):
            loader = BatchLoader(
                SyntheticCropDataset(18, insize=368, n_samples=64), 10,
                max_persons=1, num_workers=4)
            it = iter(loader)
            for _ in range(3):
                next(it)
            loader.close()
            assert loader._pool is None and not loader._feeders
        print("closed")
    """)
    done = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "closed"


def test_batch_loader_final_partial_batch_without_repeat():
    ds = SyntheticCropDataset(21, insize=16, n_samples=5, seed=1)
    batches = list(BatchLoader(ds, 2, max_persons=1, shuffle=False,
                               repeat=False))
    assert [len(b.imgs) for b in batches] == [2, 2, 1]
    assert batches[0].poses.shape == (2, 1, 21, 3)


# ------------------------------------------------------------ mini-COCO


def _coco_keypoints(xys, vis=2):
    kpts = []
    for i in range(17):
        kpts += ([int(xys[i][0]), int(xys[i][1]), vis] if i in xys
                 else [0, 0, 0])
    return kpts


def _mask_counts(mask):
    """Column-major run lengths, starting with a run of zeros."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    return counts


def _rle_string(counts):
    """COCO's compressed RLE string of ``counts`` (pycocotools' encoding:
    6-bit chunks + 48, bit 5 continues, counts after the second stored as
    deltas from the count two back)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """4 images: a person each, an under-annotated one, a crowd region as
    uncompressed RLE on image 1 and as a compressed RLE string on image
    2, and a crowd of 20 annotated persons on image 4 (over
    ``max_persons``).  Skips without cv2."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("coco_port")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    h, w = 240, 320
    images, anns = [], []

    def add(img_id, **ann):
        anns.append({"id": len(anns) + 1, "image_id": img_id,
                     "category_id": 1, "iscrowd": 0, **ann})

    for img_id in (1, 2, 3, 4):
        name = f"{img_id:012d}.jpg"
        cv2.imwrite(str(img_dir / name),
                    rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        xys = {i: (40 + 10 * i + img_id, 60 + 7 * i) for i in range(17)}
        add(img_id, keypoints=_coco_keypoints(xys), num_keypoints=17,
            area=5000.0,
            segmentation=[[30, 30, 120, 30, 120, 200, 30, 200]])
        add(img_id, keypoints=_coco_keypoints({0: (200, 50)}),
            num_keypoints=1, area=1500.0,
            segmentation=[[190, 40, 230, 40, 230, 90, 190, 90]])
    crowd = np.zeros((h, w), np.uint8)
    crowd[100:140, 250:300] = 1
    counts = _mask_counts(crowd)
    add(1, keypoints=[0] * 51, num_keypoints=0, area=2000.0, iscrowd=1,
        segmentation={"counts": counts, "size": [h, w]})
    crowd[:] = 0
    crowd[150:200, 200:260] = 1
    add(2, keypoints=[0] * 51, num_keypoints=0, area=3000.0, iscrowd=1,
        segmentation={"counts": _rle_string(_mask_counts(crowd)),
                      "size": [h, w]})
    for p in range(20):
        xys = {i: (20 + 13 * p + i, 30 + 9 * i) for i in range(17)}
        add(4, keypoints=_coco_keypoints(xys), num_keypoints=17,
            area=2000.0, segmentation=[[0, 0, 10, 0, 10, 10, 0, 10]])
    ann_file = root / "person_keypoints.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person"}]}))
    # the JAX package's ignore masks, which the dataset tests read
    jds.generate_ignore_masks(str(ann_file), str(img_dir),
                              str(root / "masks"))
    return {"root": root, "ann": str(ann_file), "img_dir": str(img_dir)}


def test_annotation_masks_equal_jax(mini_coco):
    """Polygons, uncompressed RLE and the compressed RLE string (the port's
    numpy decoder against the JAX package's decoder)."""
    ours = tcoco.CocoAnnotations(mini_coco["ann"])
    ref = jcoco.CocoAnnotations(mini_coco["ann"])
    assert ours.img_ids_with_person() == ref.img_ids_with_person()
    seen = set()
    for img_id in ours.img_ids_with_person():
        for a, b in zip(ours.annotations(img_id), ref.annotations(img_id)):
            got = tcoco.ann_to_mask(a, 240, 320)
            np.testing.assert_array_equal(got, jcoco.ann_to_mask(b, 240, 320))
            seg = a["segmentation"]
            seen.add(type(seg["counts"]).__name__ if isinstance(seg, dict)
                     else "polygon")
    assert seen == {"polygon", "list", "str"}
    np.testing.assert_array_equal(
        tds.parse_annotations(ours.annotations(4)),
        jds.parse_annotations(ref.annotations(4)))


def test_generate_ignore_masks_equal_jax(mini_coco):
    import cv2

    root = mini_coco["root"]
    n = tds.generate_ignore_masks(mini_coco["ann"], mini_coco["img_dir"],
                                  str(root / "masks_port"))
    assert n == len(list((root / "masks").iterdir())) == 4
    for img_id in (1, 2, 3, 4):
        name = f"{img_id:012d}.png"
        np.testing.assert_array_equal(
            cv2.imread(str(root / "masks_port" / name), 0),
            cv2.imread(str(root / "masks" / name), 0))


def test_augment_equals_jax_on_one_random_state(mini_coco):
    import cv2

    img = cv2.imread(str(mini_coco["img_dir"] + "/000000000001.jpg"))
    ref_ds = jds.CocoPoseDataset(mini_coco["ann"], mini_coco["img_dir"],
                                 cfg=JaxTrainConfig(insize=64))
    poses = jds.parse_annotations(
        ref_ds._valid_annotations(1))
    mask = np.zeros(img.shape[:2], bool)
    mask[100:140, 250:300] = True
    for seed in range(4):
        got = augment(img, mask, poses, TrainConfig(insize=64),
                           np.random.RandomState(seed))
        want = jax_augment(img, mask, poses, JaxTrainConfig(insize=64),
                            np.random.RandomState(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_coco_pose_dataset_samples_equal_jax(mini_coco, mode):
    """Samples, masks and poses of the augmented dataset bit-equal to the
    JAX package's from one seed, the 20-person image's overflow (over
    ``max_persons`` = 16) masked alike."""
    kwargs = dict(mask_dir=str(mini_coco["root"] / "masks"), mode=mode,
                  n_samples=3 if mode == "val" else None, seed=5)
    ours = tds.CocoPoseDataset(mini_coco["ann"], mini_coco["img_dir"],
                               cfg=TrainConfig(insize=64), **kwargs)
    ref = jds.CocoPoseDataset(mini_coco["ann"], mini_coco["img_dir"],
                              cfg=JaxTrainConfig(insize=64), **kwargs)
    assert list(ours.img_ids) == list(ref.img_ids)
    for i in range(len(ours)):
        overflow = ours.img_ids[i] == 4
        with pytest.warns() if overflow else contextlib.nullcontext():
            got = ours.sample(i)
        with pytest.warns() if overflow else contextlib.nullcontext():
            want = ref.sample(i)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- reports


def test_train_logger_log_equals_jax(tmp_path, capsys):
    ours = trep.TrainLogger(str(tmp_path / "port"), log_interval=2)
    ref = jrep.TrainLogger(str(tmp_path / "jax"), log_interval=2)
    rng = np.random.RandomState(0)
    for it in range(1, 6):
        scalars = {"main/loss": rng.rand(), "main/paf": rng.rand(),
                   "main/heat": rng.rand()}
        if it == 4:
            scalars["val/loss"] = 0.5
        ours.observe(it, scalars, epoch=it // 3)
        ref.observe(it, scalars, epoch=it // 3)
    got = json.loads((tmp_path / "port" / "log").read_text())
    want = json.loads((tmp_path / "jax" / "log").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key != "elapsed_time":
                assert g[key] == w[key], key
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2]  # the same header from both loggers


def test_params_json_has_the_jax_clis_keys(tmp_path):
    from tpupose.apps import train_cli as jcli
    from tpupose_torch.apps import train_cli as tcli

    argv = ["--synthetic", "--test", "--arch", "handnet", "-B", "4"]
    ours, ref = vars(tcli.parse_args(argv)), vars(jcli.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    trep.dump_run_params(str(tmp_path / "port"), ours)
    jrep.dump_run_params(str(tmp_path / "jax"), ref)
    assert ((tmp_path / "port" / "params.json").read_text()
            == (tmp_path / "jax" / "params.json").read_text())
    assert len(list((tmp_path / "port").glob("@*"))) == 1
