"""Overlay drawing of poses, face and hand keypoints (a copy of
``tpupose/detectors/draw.py``: the same colors and geometry, so result
images compare).  cv2 is imported inside each function, so importing this
module needs none.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.config import FACE_LINES, FINGER_LINES
from tpupose_torch.topology import COCO18, Topology

_LIMB_COLORS = [
    [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255], [0, 170, 255],
    [0, 85, 255], [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
    [255, 0, 85], [170, 255, 0], [85, 255, 0], [170, 0, 255], [0, 0, 255],
    [0, 0, 255], [255, 0, 255], [170, 0, 255], [255, 0, 170],
]

_JOINT_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


def _colors(base, n: int):
    """``n`` colors: ``base`` in order, repeated past its end (BODY_25 has
    26 pairs and 25 parts, COCO 19 and 18)."""
    return [base[i % len(base)] for i in range(n)]


def draw_person_pose(orig_img: np.ndarray, poses,
                     topology: Topology = COCO18) -> np.ndarray:
    """(N, J, 3) poses over ``orig_img``: each pair of ``topology`` as a
    line (the non-spawning shoulder-ear pairs are not drawn), or each edge
    of its skeleton where it has no pairs (COCO-17), each part as a
    dot."""
    import cv2

    if len(poses) == 0:
        return orig_img
    canvas = orig_img.copy()

    poses = np.asarray(poses)
    present = poses[..., 2] != 0      # a flag, or a joint's value
    xy = poses[..., :2].round().astype(int)
    edges = topology.skeleton or topology.limbs
    limb_colors = _colors(_LIMB_COLORS, len(edges))
    for pose, seen in zip(xy, present):
        for i, ((ja, jb), color) in enumerate(zip(edges, limb_colors)):
            if i in topology.non_spawning:  # no shoulder-ear connections
                continue
            if seen[ja] and seen[jb]:
                cv2.line(canvas, tuple(pose[ja]), tuple(pose[jb]), color, 2)
    joint_colors = _colors(_JOINT_COLORS, topology.num_joints)
    for pose, seen in zip(xy, present):
        for (x, y), v, color in zip(pose, seen, joint_colors):
            if v:
                cv2.circle(canvas, (int(x), int(y)), 3, color, -1)
    return canvas


def draw_face_keypoints(orig_img: np.ndarray, face_keypoints,
                        left_top=(0, 0)) -> np.ndarray:
    import cv2

    img = orig_img.copy()
    left, top = left_top
    for kp in face_keypoints:
        if kp:
            x, y, _ = kp
            cv2.circle(img, (int(x) + left, int(y) + top), 2,
                       (255, 255, 0), -1)
    for i, j in FACE_LINES:
        a, b = face_keypoints[i], face_keypoints[j]
        if a and b:
            cv2.line(img, (int(a[0]) + left, int(a[1]) + top),
                     (int(b[0]) + left, int(b[1]) + top), (255, 255, 0), 1)
    return img


def draw_hand_keypoints(orig_img: np.ndarray, hand_keypoints,
                        left_top=(0, 0)) -> np.ndarray:
    import cv2

    img = orig_img.copy()
    left, top = left_top
    finger_colors = [(0, 0, 255), (0, 255, 255), (0, 255, 0),
                     (255, 0, 0), (255, 0, 255)]
    for f, finger in enumerate(FINGER_LINES):
        for i, j in finger:
            a, b = hand_keypoints[i], hand_keypoints[j]
            if a:
                cv2.circle(img, (int(a[0]) + left, int(a[1]) + top), 3,
                           finger_colors[f], -1)
            if b:
                cv2.circle(img, (int(b[0]) + left, int(b[1]) + top), 3,
                           finger_colors[f], -1)
            if a and b:
                cv2.line(img, (int(a[0]) + left, int(a[1]) + top),
                         (int(b[0]) + left, int(b[1]) + top),
                         finger_colors[f], 1)
    return img
