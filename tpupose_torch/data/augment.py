"""Host-side training augmentations with cv2 (a copy of
``tpupose/data/augment.py``, the reference data loader's semantics).

The chain resize -> rotate -> crop -> color -> flip on
``(img, ignore_mask, poses)`` triples.  These are host ops (uint8 images of
varying size, cv2 warps); the GT maps are rendered on the device
(``tpupose_torch.data.gt``).

Randomness is drawn from an explicit ``np.random.RandomState`` so data
workers are reproducible, instead of the reference's mix of global
``random`` / ``np.random``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from tpupose_torch.config import FLIP_PAIRS, TrainConfig

Triple = Tuple[np.ndarray, np.ndarray, np.ndarray]


def pose_bboxes(poses: np.ndarray) -> np.ndarray:
    """(P, 18, 3) -> (P, 4) [x1, y1, x2, y2] over labeled joints
    (ref ``coco_data_loader.py:61-70``)."""
    boxes = []
    for pose in poses:
        pts = pose[pose[:, 2] > 0][:, :2]
        boxes.append([pts[:, 0].min(), pts[:, 1].min(),
                      pts[:, 0].max(), pts[:, 1].max()])
    return np.asarray(boxes, np.float64)


def resize_triple(img, ignore_mask, poses, wh: Tuple[int, int]) -> Triple:
    """Resize image+mask to (w, h) and scale pose coords
    (ref ``:72-79``)."""
    import cv2

    h, w = img.shape[:2]
    out_img = cv2.resize(img, wh)
    out_mask = cv2.resize(ignore_mask.astype(np.uint8), wh).astype(bool)
    poses = poses.copy()
    poses[:, :, :2] = poses[:, :, :2] * np.asarray(wh) / np.asarray((w, h))
    return out_img, out_mask, poses


def random_resize(img, ignore_mask, poses, cfg: TrainConfig,
                  rng: np.random.RandomState) -> Triple:
    """Scale so the smallest person is >= min_box_size and the largest
    <= max_box_size, clamped to [min_scale, max_scale] (ref ``:81-103``)."""
    h, w = img.shape[:2]
    boxes = pose_bboxes(poses)
    sizes = np.sqrt(((boxes[:, 2:] - boxes[:, :2] + 1) ** 2).sum(axis=1))

    lo = min(max(cfg.min_box_size / sizes.min(), cfg.min_scale), 1.0)
    hi = min(max(cfg.max_box_size / sizes.max(), 1.0), cfg.max_scale)
    scale = float((hi - lo) * rng.random_sample() + lo)
    return resize_triple(img, ignore_mask, poses,
                         (round(w * scale), round(h * scale)))


def random_rotate(img, ignore_mask, poses, cfg: TrainConfig,
                  rng: np.random.RandomState) -> Triple:
    """Rotate about the center by ``randn()/3 * max_degree`` with the
    bounding canvas expanded to fit, gray border (ref ``:105-124``)."""
    import cv2

    h, w = img.shape[:2]
    degree = rng.randn() / 3 * cfg.max_rotate_degree
    rad = math.radians(degree)
    center = (w / 2, h / 2)
    rot = cv2.getRotationMatrix2D(center, degree, 1)
    bbox_w = w * abs(math.cos(rad)) + h * abs(math.sin(rad))
    bbox_h = w * abs(math.sin(rad)) + h * abs(math.cos(rad))
    rot[0, 2] += bbox_w / 2 - center[0]
    rot[1, 2] += bbox_h / 2 - center[1]
    out_wh = (int(bbox_w + 0.5), int(bbox_h + 0.5))
    out_img = cv2.warpAffine(img, rot, out_wh, flags=cv2.INTER_CUBIC,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=[127.5, 127.5, 127.5])
    out_mask = cv2.warpAffine(ignore_mask.astype(np.uint8) * 255, rot,
                              out_wh) > 0
    out_poses = poses.copy()
    ones = np.concatenate(
        [poses[:, :, :2], np.ones_like(poses[:, :, :1])], axis=2)
    out_poses[:, :, :2] = ones @ rot.T
    return out_img, out_mask, out_poses


def random_crop(img, ignore_mask, poses, cfg: TrainConfig,
                rng: np.random.RandomState) -> Triple:
    """Crop an ``insize`` square around a randomly chosen person's bbox
    center with a uniform perturbation, gray padding (ref ``:126-160``)."""
    h, w = img.shape[:2]
    insize = cfg.insize
    boxes = pose_bboxes(poses)
    box = boxes[rng.randint(len(boxes))]
    center = box[:2] + (box[2:] - box[:2]) / 2
    perturb = (rng.random_sample(2) - 0.5) * 2 * cfg.center_perturb_max
    center = (center + perturb + 0.5).astype(np.int32)

    crop_img = np.full((insize, insize, 3), 127.5).astype(np.uint8)
    crop_mask = np.zeros((insize, insize), bool)

    offset = (center - (insize - 1) / 2 + 0.5).astype(np.int32)
    offset_end = (center + (insize - 1) / 2 - (w - 1, h - 1)
                  + 0.5).astype(np.int32)

    x1, y1 = np.maximum(offset, 0)
    x2 = min(int(center[0] + (insize - 1) / 2 + 0.5), w - 1)
    y2 = min(int(center[1] + (insize - 1) / 2 + 0.5), h - 1)

    x_from = -offset[0] if offset[0] < 0 else 0
    y_from = -offset[1] if offset[1] < 0 else 0
    x_to = insize - offset_end[0] - 1 if offset_end[0] >= 0 else insize - 1
    y_to = insize - offset_end[1] - 1 if offset_end[1] >= 0 else insize - 1

    crop_img[y_from:y_to + 1, x_from:x_to + 1] = img[y1:y2 + 1, x1:x2 + 1]
    crop_mask[y_from:y_to + 1, x_from:x_to + 1] = \
        ignore_mask[y1:y2 + 1, x1:x2 + 1]

    out_poses = poses.copy()
    out_poses[:, :, :2] -= offset
    return crop_img, crop_mask, out_poses


def distort_color(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """HSV jitter: hue +-10, saturation +-40, value +-30, clipped to u8
    (ref ``:162-173``)."""
    import cv2

    hsv = cv2.cvtColor(img.copy(), cv2.COLOR_BGR2HSV).astype(np.int32)
    hsv[:, :, 0] = np.clip(hsv[:, :, 0] - 10 + rng.randint(20 + 1), 0, 255)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] - 40 + rng.randint(80 + 1), 0, 255)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] - 30 + rng.randint(60 + 1), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


def flip_horizontal(img, ignore_mask, poses) -> Triple:
    """Mirror image/mask/poses and swap left/right joints
    (ref ``:175-193``)."""
    import cv2

    out_img = cv2.flip(img, 1)
    out_mask = cv2.flip(ignore_mask.astype(np.uint8), 1).astype(bool)
    out_poses = poses.copy()
    out_poses[:, :, 0] = img.shape[1] - 1 - out_poses[:, :, 0]
    for a, b in FLIP_PAIRS:
        tmp = out_poses[:, a].copy()
        out_poses[:, a] = out_poses[:, b]
        out_poses[:, b] = tmp
    return out_img, out_mask, out_poses


def augment(img, ignore_mask, poses, cfg: TrainConfig,
            rng: np.random.RandomState) -> Triple:
    """Full chain (ref ``:195-205``): resize -> rotate -> crop ->
    color (p=0.5) -> flip (p=0.5).  Output image is ``insize`` square."""
    img, ignore_mask, poses = random_resize(img, ignore_mask, poses, cfg,
                                            rng)
    img, ignore_mask, poses = random_rotate(img, ignore_mask, poses, cfg,
                                            rng)
    img, ignore_mask, poses = random_crop(img, ignore_mask, poses, cfg, rng)
    if rng.randint(2):
        img = distort_color(img, rng)
    if rng.randint(2):
        img, ignore_mask, poses = flip_horizontal(img, ignore_mask, poses)
    return img, ignore_mask, poses
