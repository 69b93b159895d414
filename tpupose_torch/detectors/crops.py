"""Anthropometric crop cascade: person unit length and face/hand/person
crops (a numpy copy of ``tpupose/detectors/crops.py``).

These run on tiny per-person arrays (18 joints) on the host; the cropped
images feed the batched face and hand detectors.  No cv2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tpupose_torch.config import LIMBS, NUM_LIMBS, JointType

# Base limbs for unit length: (neck-nose, neck-leftwaist, neck-rightwaist,
# leftshoulder-leftear, rightshoulder-rightear) with their length ratios.
_BASE_LIMB_IDS = np.array([14, 3, 0, 13, 9])
_BASE_LIMB_RATIOS = np.array([0.85, 2.2, 2.2, 0.85, 0.85])
# Fallback ratios for all 19 limbs.
_ALL_LIMB_RATIOS = np.array([
    2.2, 1.7, 1.7, 2.2, 1.7, 1.7, 0.6, 0.93, 0.65, 0.85,
    0.6, 0.93, 0.65, 0.85, 1.0, 0.2, 0.2, 0.25, 0.25])

# crop_person joint priority / padding tables.
_BIG = np.iinfo(np.int64).max
_TOP_JOINT_PRIORITY = [4, 5, 6, 12, 16, 7, 13, 17, 8, 10, 14, 9, 11, 15,
                       2, 3, 0, 1, _BIG]
_BOTTOM_JOINT_PRIORITY = [9, 6, 7, 14, 16, 8, 15, 17, 4, 2, 0, 5, 3, 1,
                          10, 11, 12, 13, _BIG]
_TOP_PADDING_RATIO = [0.9, 1.9, 1.9, 2.9, 3.7, 1.9, 2.9, 3.7, 4.0, 5.5,
                      7.0, 4.0, 5.5, 7.0, 0.7, 0.8, 0.7, 0.8]
_BOTTOM_PADDING_RATIO = [6.9, 5.9, 5.9, 4.9, 4.1, 5.9, 4.9, 4.1, 3.8, 2.3,
                         0.8, 3.8, 2.3, 0.8, 7.1, 7.0, 7.1, 7.0]


def compute_limbs_length(pose: np.ndarray):
    """pose: (18, 3).  Returns (limbs_len (19,), limbs list).

    Limbs are measured for EVERY joint pair, absent joints (stored at
    (0, 0)) included, as the JAX package does: a visibility gate here would
    change unit lengths whenever a joint is occluded."""
    limbs_len = np.zeros(NUM_LIMBS)
    limbs = []
    for i, (ja, jb) in enumerate(LIMBS):
        limbs.append((pose[ja], pose[jb]))
        limbs_len[i] = np.linalg.norm(
            pose[jb][:2].astype(np.float64) - pose[ja][:2])
    return limbs_len, limbs


def compute_unit_length(limbs_len: np.ndarray) -> float:
    """Person scale estimate from limb-length ratio tables."""
    base = limbs_len[_BASE_LIMB_IDS]
    nz = base > 0
    if nz.any():
        return float(np.sum(base[nz] / _BASE_LIMB_RATIOS[nz]) / nz.sum())
    nz = limbs_len > 0
    if not nz.any():
        return 0.0
    return float(np.sum(limbs_len[nz] / _ALL_LIMB_RATIOS[nz]) / nz.sum())


def get_unit_length(pose: np.ndarray) -> float:
    limbs_len, _ = compute_limbs_length(pose)
    return compute_unit_length(limbs_len)


def crop_image(img: np.ndarray, bbox) -> np.ndarray:
    """Zero-padded out-of-bounds crop."""
    left, top, right, bottom = bbox
    img_h, img_w, img_ch = img.shape
    box_h, box_w = bottom - top, right - left

    crop_left, crop_top = max(0, left), max(0, top)
    crop_right, crop_bottom = min(img_w, right), min(img_h, bottom)
    cropped = img[crop_top:crop_bottom, crop_left:crop_right]

    bias_x = crop_left - left if left < crop_left else 0
    bias_y = crop_top - top if top < crop_top else 0

    padded = np.zeros((box_h, box_w, img_ch), np.uint8)
    padded[bias_y:bias_y + cropped.shape[0],
           bias_x:bias_x + cropped.shape[1]] = cropped
    return padded


def crop_around_keypoint(img: np.ndarray, keypoint, crop_size: float):
    """Square crop centred on a keypoint."""
    x, y = keypoint
    bbox = (int(x - crop_size), int(y - crop_size),
            int(x + crop_size), int(y + crop_size))
    return crop_image(img, bbox), bbox


def crop_face(img: np.ndarray, pose: np.ndarray, unit_length: float):
    """Face ROI from the nose position."""
    if pose[JointType.Nose][2] <= 0:
        return None, None
    nose = pose[JointType.Nose][:2]
    bbox = (int(nose[0] - unit_length), int(nose[1] - unit_length * 1.2),
            int(nose[0] + unit_length), int(nose[1] + unit_length * 0.8))
    return crop_image(img, bbox), bbox


def crop_hands(img: np.ndarray, pose: np.ndarray, unit_length: float
               ) -> Dict[str, Optional[dict]]:
    """Hand ROIs extrapolated from wrist+elbow."""
    hands: Dict[str, Optional[dict]] = {"left": None, "right": None}
    for side, hand_j, elbow_j in (
            ("left", JointType.LeftHand, JointType.LeftElbow),
            ("right", JointType.RightHand, JointType.RightElbow)):
        if pose[hand_j][2] <= 0:
            continue
        center = pose[hand_j][:2].astype(np.float64).copy()
        if pose[elbow_j][2] > 0:
            direction = pose[hand_j][:2] - pose[elbow_j][:2]
            center += 0.3 * direction
        hand_img, bbox = crop_around_keypoint(img, center,
                                              unit_length * 0.95)
        hands[side] = {"img": hand_img, "bbox": bbox}
    return hands


def crop_person(img: np.ndarray, pose: np.ndarray, unit_length: float):
    """Whole-person ROI with per-joint padding tables."""
    top_joint_index = len(_TOP_JOINT_PRIORITY) - 1
    bottom_joint_index = len(_BOTTOM_JOINT_PRIORITY) - 1
    left_pos = top_pos = _BIG
    right_pos = bottom_pos = 0

    for i, joint in enumerate(pose):
        if joint[2] > 0:
            if _TOP_JOINT_PRIORITY[i] < _TOP_JOINT_PRIORITY[top_joint_index]:
                top_joint_index = i
            elif (_BOTTOM_JOINT_PRIORITY[i]
                  < _BOTTOM_JOINT_PRIORITY[bottom_joint_index]):
                bottom_joint_index = i
            if joint[1] < top_pos:
                top_pos = joint[1]
            elif joint[1] > bottom_pos:
                bottom_pos = joint[1]
            if joint[0] < left_pos:
                left_pos = joint[0]
            elif joint[0] > right_pos:
                right_pos = joint[0]

    if (top_joint_index >= len(_TOP_PADDING_RATIO)
            or bottom_joint_index >= len(_BOTTOM_PADDING_RATIO)):
        # no visible joints, or every visible joint won the top-priority
        # branch leaving the bottom sentinel in place (e.g. only nose +
        # right eye/ear visible)
        return None, None
    bbox = (
        int(left_pos - 0.3 * unit_length),
        int(top_pos - _TOP_PADDING_RATIO[top_joint_index] * unit_length),
        int(right_pos + 0.3 * unit_length),
        int(bottom_pos
            + _BOTTOM_PADDING_RATIO[bottom_joint_index] * unit_length),
    )
    return crop_image(img, bbox), bbox


def crop_face_haar(img: np.ndarray, rect, crop_scale: float = 1.5):
    """Square crop around a Haar-cascade face rect."""
    img_h, img_w = img.shape[:2]
    cx, cy = rect[0] + rect[2] / 2, rect[1] + rect[3] / 2
    cw, ch = rect[2] * crop_scale, rect[3] * crop_scale
    left = max(0, int(cx - cw / 2))
    top = max(0, int(cy - ch / 2))
    right = min(img_w - 1, int(cx + cw / 2))
    bottom = min(img_h - 1, int(cy + ch / 2))
    cropped = img[top:bottom, left:right]
    edge = int(np.max(cropped.shape[:2]))
    padded = np.zeros((edge, edge, cropped.shape[-1]), np.uint8)
    padded[:cropped.shape[0], :cropped.shape[1]] = cropped
    return padded, (left, top)
