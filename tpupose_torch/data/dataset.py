"""COCO keypoint dataset: annotation parsing, filtering, sample assembly
(a copy of ``tpupose/data/dataset.py``).

* host (this module and ``augment.py``): decode the image, convert the
  keypoints, augment, resize; emits ``(img u8, poses, ignore_mask)``;
* device (``tpupose_torch.data.gt`` inside the train step): render the GT
  heatmaps and PAFs.

``sample()`` therefore returns pose tables, not label maps;
``tpupose_torch.train.pad_poses`` batches them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from tpupose_torch.config import (
    COCO_JOINT_ORDER,
    NUM_JOINTS,
    JointType,
    TrainConfig,
)
from tpupose_torch.data import coco_json
from tpupose_torch.data.augment import augment, resize_triple


def parse_annotations(annotations: List[dict]) -> np.ndarray:
    """COCO 17-kpt annotations -> (P, 18, 3) int32 pose array with the neck
    synthesized as the shoulder midpoint (ref ``coco_data_loader.py:311-332``).
    """
    poses = np.zeros((len(annotations), NUM_JOINTS, 3), np.int32)
    for p, ann in enumerate(annotations):
        kpts = np.asarray(ann["keypoints"], np.int32).reshape(-1, 3)
        for i, joint_idx in enumerate(COCO_JOINT_ORDER):
            poses[p, joint_idx] = kpts[i]
        ls = poses[p, JointType.LeftShoulder]
        rs = poses[p, JointType.RightShoulder]
        if ls[2] > 0 and rs[2] > 0:
            poses[p, JointType.Neck, 0] = int((ls[0] + rs[0]) / 2)
            poses[p, JointType.Neck, 1] = int((ls[1] + rs[1]) / 2)
            poses[p, JointType.Neck, 2] = 2
    return poses


class CocoPoseDataset:
    """Indexable dataset over COCO person-keypoint images.

    mode='train'|'val': returns augmented/resized training triples.
    mode='eval':        returns raw image + annotations + img_id (for the
                        AP harness; ref ``:346-348``).
    """

    def __init__(self, ann_file: str, img_dir: str,
                 mask_dir: Optional[str] = None,
                 mode: str = "train",
                 cfg: TrainConfig = TrainConfig(),
                 n_samples: Optional[int] = None,
                 seed: int = 0):
        assert mode in ("train", "val", "eval")
        self.coco = coco_json.CocoAnnotations(ann_file)
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.mode = mode
        self.cfg = cfg
        if mode == "eval":
            # official COCO protocol scores EVERY image in the split —
            # detections on person-free images must count as false
            # positives (the reference restricts even eval mode to person
            # images, inflating AP; parity with pycocotools wins here)
            self.img_ids = sorted(self.coco.imgs.keys())
        else:
            self.img_ids = self.coco.img_ids_with_person()
        if mode in ("val", "eval") and n_samples is not None:
            rng = np.random.RandomState(seed)
            n = min(n_samples, len(self.img_ids))
            self.img_ids = list(
                rng.choice(self.img_ids, n, replace=False))
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.img_ids)

    # ------------------------------------------------------------------

    def _valid_annotations(self, img_id: int) -> Optional[List[dict]]:
        """Persons with >= min_keypoints keypoints and area > min_area
        (ref ``:282-292``)."""
        anns = [
            a for a in self.coco.annotations(img_id)
            if a.get("num_keypoints", 0) >= self.cfg.min_keypoints
            and a.get("area", 0) > self.cfg.min_area
        ]
        return anns or None

    def load_image(self, img_id: int) -> np.ndarray:
        import cv2

        info = self.coco.image_info(img_id)
        img = cv2.imread(os.path.join(self.img_dir, info["file_name"]))
        if img is None:
            raise FileNotFoundError(
                f"image {info['file_name']} not found in {self.img_dir}")
        return img

    def load_ignore_mask(self, img_id: int,
                         shape: Tuple[int, int]) -> np.ndarray:
        """Offline ignore mask, or zeros when absent (ref ``:301-305``)."""
        import cv2

        if self.mask_dir:
            path = os.path.join(self.mask_dir, f"{img_id:012d}.png")
            if os.path.exists(path):
                mask = cv2.imread(path, 0)
                if mask is not None:
                    return mask == 255
        return np.zeros(shape, bool)

    # ------------------------------------------------------------------

    def sample(self, index: int):
        """Training/val sample: (img u8 (S,S,3), poses (P,18,3) f32,
        ignore_mask (S,S) bool).  Images without valid annotations are
        resampled (ref ``:350-353``); BOTH train and val samples go
        through the augmentation chain (the reference's
        ``generate_labels`` augments unconditionally, ``:334-341``).

        Poses stay int32 through augmentation: the reference assigns every
        stage's float results back into int32 arrays, truncating after
        each of resize/rotate/crop (``coco_data_loader.py:78,119-123``) —
        GT Gaussian centers and PAF bands inherit that quantization.
        """
        img_id = self.img_ids[index]
        anns = self._valid_annotations(img_id)
        retries = 0
        while anns is None:
            if retries > 10 * len(self.img_ids) + 100:
                raise RuntimeError(
                    "no image in the dataset has annotations passing the "
                    f"min_keypoints={self.cfg.min_keypoints}/"
                    f"min_area={self.cfg.min_area} filter")
            img_id = self.img_ids[self._rng.randint(len(self.img_ids))]
            anns = self._valid_annotations(img_id)
            retries += 1

        img = self.load_image(img_id)
        ignore_mask = self.load_ignore_mask(img_id, img.shape[:2])
        poses = parse_annotations(anns)  # int32, as the reference keeps it

        img, ignore_mask, poses = augment(
            img, ignore_mask, poses, self.cfg, self._rng)
        img, ignore_mask, poses = resize_triple(
            img, ignore_mask, poses, (self.cfg.insize, self.cfg.insize))

        # The reference dilates the mask AFTER augmentation with a 16x16
        # kernel (``:340``).
        import cv2

        k = self.cfg.mask_dilate_ksize
        ignore_mask = cv2.morphologyEx(
            ignore_mask.astype(np.uint8), cv2.MORPH_DILATE,
            np.ones((k, k))).astype(bool)

        # Static capacity: persons beyond max_persons can't be rendered
        # into the GT table — mask their regions out so the loss doesn't
        # train their (correct) detections as background (the reference
        # renders all persons; dropping without masking would actively
        # penalize them).
        if len(poses) > self.cfg.max_persons:
            if not getattr(self, "_warned_person_overflow", False):
                import warnings

                self._warned_person_overflow = True
                warnings.warn(
                    f"image {img_id}: {len(poses)} annotated persons exceed "
                    f"max_persons={self.cfg.max_persons}; the overflow is "
                    "masked out of the loss (raise TrainConfig.max_persons "
                    "to train on them)", RuntimeWarning, stacklevel=2)
            for pose in poses[self.cfg.max_persons:]:
                pts = pose[pose[:, 2] > 0]
                if not len(pts):
                    continue
                pad = int(self.cfg.heatmap_sigma * 2)
                x0 = max(int(pts[:, 0].min()) - pad, 0)
                y0 = max(int(pts[:, 1].min()) - pad, 0)
                x1 = min(int(pts[:, 0].max()) + pad, self.cfg.insize)
                y1 = min(int(pts[:, 1].max()) + pad, self.cfg.insize)
                ignore_mask[y0:y1, x0:x1] = True
            poses = poses[:self.cfg.max_persons]
        return img, poses.astype(np.float32), ignore_mask

    def eval_sample(self, index: int):
        """(img, annotations, img_id) for the AP harness."""
        img_id = self.img_ids[index]
        img = self.load_image(img_id)
        return img, self.coco.annotations(img_id), img_id


def visualize_ignore_mask(img: np.ndarray, mask_miss: np.ndarray,
                          annotations: List[dict]) -> np.ndarray:
    """Debug overlay: ignored regions tinted red, keypoints drawn
    (the ``--vis`` mode of ``gen_ignore_mask.py:48-71,103-111``)."""
    import cv2

    out = img.copy()
    tint = np.zeros_like(out)
    tint[..., 2] = 255
    m = mask_miss.astype(bool)
    out[m] = (0.3 * out[m] + 0.7 * tint[m]).astype(np.uint8)
    for ann in annotations:
        for x, y, v in np.asarray(ann.get("keypoints", []),
                                  np.int32).reshape(-1, 3):
            if v == 1:
                cv2.circle(out, (int(x), int(y)), 3, (255, 255, 0), -1)
            elif v == 2:
                cv2.circle(out, (int(x), int(y)), 3, (255, 0, 255), -1)
    return np.hstack([img, out])


def generate_ignore_masks(ann_file: str, img_dir: str, out_dir: str,
                          cfg: TrainConfig = TrainConfig(),
                          limit: Optional[int] = None,
                          vis_dir: Optional[str] = None) -> int:
    """Offline ignore-mask generation (ref ``gen_ignore_mask.py:23-37,
    86-116``): for every image, union the masks of crowd regions and of
    under-annotated persons; write ``<out_dir>/<id>.png`` when non-empty.

    Returns the number of masks written.
    """
    import cv2

    coco = coco_json.CocoAnnotations(ann_file)
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    ids = coco.img_ids_with_person()
    if limit:
        ids = ids[:limit]
    for img_id in ids:
        info = coco.image_info(img_id)
        h, w = info["height"], info["width"]
        mask_all = np.zeros((h, w), bool)
        mask_miss = np.zeros((h, w), bool)
        for ann in coco.annotations(img_id):
            mask = coco_json.ann_to_mask(ann, h, w).astype(bool)
            if ann.get("iscrowd") == 1:
                # crowd: miss everything not already covered by a person
                mask_miss |= mask & ~(mask_all & mask)
                mask_all |= mask
            elif (ann.get("num_keypoints", 0) < cfg.min_keypoints
                  or ann.get("area", 0) <= cfg.min_area):
                mask_all |= mask
                mask_miss |= mask
            else:
                mask_all |= mask
        if np.any(mask_miss):
            cv2.imwrite(os.path.join(out_dir, f"{img_id:012d}.png"),
                        mask_miss.astype(np.uint8) * 255)
            written += 1
            if vis_dir:
                os.makedirs(vis_dir, exist_ok=True)
                try:
                    img = cv2.imread(os.path.join(
                        img_dir, coco.image_info(img_id)["file_name"]))
                    if img is not None:
                        panel = visualize_ignore_mask(
                            img, mask_miss, coco.annotations(img_id))
                        cv2.imwrite(os.path.join(
                            vis_dir, f"{img_id:012d}.png"), panel)
                except Exception:
                    pass  # visualization must never block generation
    return written
