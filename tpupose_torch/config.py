"""The pose schema, inference and training configuration of the port.

The port's own copy of what it uses from ``tpupose/config.py``: the
18-joint skeleton, the 19-limb PAF topology, the COCO joint order and the
flip pairs, ``InferenceConfig``, ``TrainConfig``, the face and hand nets'
``FaceConfig`` / ``HandConfig`` and their drawing topologies, with the same
values, so the port imports nothing of the JAX package.
``tests/test_torch_config.py`` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class JointType(enum.IntEnum):
    """The 18 joints of the pose network's skeleton."""

    Nose = 0
    Neck = 1
    RightShoulder = 2
    RightElbow = 3
    RightHand = 4
    LeftShoulder = 5
    LeftElbow = 6
    LeftHand = 7
    RightWaist = 8
    RightKnee = 9
    RightFoot = 10
    LeftWaist = 11
    LeftKnee = 12
    LeftFoot = 13
    RightEye = 14
    LeftEye = 15
    RightEar = 16
    LeftEar = 17


NUM_JOINTS = len(JointType)  # 18

# 19 limbs connecting joint pairs; PAF channels 2*i and 2*i+1 encode limb i.
LIMBS: Tuple[Tuple[int, int], ...] = (
    (JointType.Neck, JointType.RightWaist),
    (JointType.RightWaist, JointType.RightKnee),
    (JointType.RightKnee, JointType.RightFoot),
    (JointType.Neck, JointType.LeftWaist),
    (JointType.LeftWaist, JointType.LeftKnee),
    (JointType.LeftKnee, JointType.LeftFoot),
    (JointType.Neck, JointType.RightShoulder),
    (JointType.RightShoulder, JointType.RightElbow),
    (JointType.RightElbow, JointType.RightHand),
    (JointType.RightShoulder, JointType.RightEar),
    (JointType.Neck, JointType.LeftShoulder),
    (JointType.LeftShoulder, JointType.LeftElbow),
    (JointType.LeftElbow, JointType.LeftHand),
    (JointType.LeftShoulder, JointType.LeftEar),
    (JointType.Neck, JointType.Nose),
    (JointType.Nose, JointType.RightEye),
    (JointType.Nose, JointType.LeftEye),
    (JointType.RightEye, JointType.RightEar),
    (JointType.LeftEye, JointType.LeftEar),
)

NUM_LIMBS = len(LIMBS)  # 19

LIMBS_FROM = np.asarray([a for a, _ in LIMBS], np.int32)
LIMBS_TO = np.asarray([b for _, b in LIMBS], np.int32)

# Limbs that never spawn a new person subset during grouping (the
# shoulder -> ear links).
NON_SPAWNING_LIMBS: Tuple[int, ...] = (9, 13)

# COCO's 17-keypoint order -> internal JointType.
COCO_JOINT_ORDER: Tuple[int, ...] = (
    JointType.Nose,
    JointType.LeftEye,
    JointType.RightEye,
    JointType.LeftEar,
    JointType.RightEar,
    JointType.LeftShoulder,
    JointType.RightShoulder,
    JointType.LeftElbow,
    JointType.RightElbow,
    JointType.LeftHand,
    JointType.RightHand,
    JointType.LeftWaist,
    JointType.RightWaist,
    JointType.LeftKnee,
    JointType.RightKnee,
    JointType.LeftFoot,
    JointType.RightFoot,
)

# Left/right joint pairs swapped on a horizontal flip.
FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (JointType.LeftEye, JointType.RightEye),
    (JointType.LeftEar, JointType.RightEar),
    (JointType.LeftShoulder, JointType.RightShoulder),
    (JointType.LeftElbow, JointType.RightElbow),
    (JointType.LeftHand, JointType.RightHand),
    (JointType.LeftWaist, JointType.RightWaist),
    (JointType.LeftKnee, JointType.RightKnee),
    (JointType.LeftFoot, JointType.RightFoot),
)

# Face: 70 keypoints; polyline segments for drawing.
FACE_LINES: Tuple[Tuple[int, int], ...] = tuple(
    [(i, i + 1) for i in range(0, 16)]        # face outline
    + [(i, i + 1) for i in range(17, 21)]     # right eyebrow
    + [(i, i + 1) for i in range(22, 26)]     # left eyebrow
    + [(i, i + 1) for i in range(27, 30)]     # nose bridge
    + [(i, i + 1) for i in range(31, 35)]     # under-nose line
    + [(36, 37), (37, 38), (38, 39), (39, 40), (40, 41), (41, 36)]  # right eye
    + [(42, 43), (43, 44), (44, 45), (45, 46), (46, 47), (47, 42)]  # left eye
    + [(i, i + 1) for i in range(48, 59)] + [(59, 48)]  # outer lips
    + [(i, i + 1) for i in range(60, 67)] + [(67, 60)]  # inner lips
)

# Hand: 21 keypoints, 5 fingers x 4 segments.
FINGER_LINES: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((0, 1), (1, 2), (2, 3), (3, 4)),
    ((0, 5), (5, 6), (6, 7), (7, 8)),
    ((0, 9), (9, 10), (10, 11), (11, 12)),
    ((0, 13), (13, 14), (14, 15), (15, 16)),
    ((0, 17), (17, 18), (18, 19), (19, 20)),
)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Pose inference parameters."""

    img_size: int = 368          # network input long/short side target
    scales: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)  # precise-mode pyramid
    heatmap_size: int = 320      # postprocess map target size (fast path)
    downscale: int = 8           # network output stride
    gaussian_sigma: float = 2.5  # heatmap smoothing before peak NMS
    # Peak NMS: "scipy" (reflect-boundary Gaussian, strict ``>`` rule) or
    # "conv" (zero-pad Gaussian conv of ``ksize``, ``>=`` rule; not ported).
    nms_mode: str = "scipy"
    ksize: int = 17              # conv-mode smoothing kernel size
    n_integ_points: int = 10     # samples along each candidate limb
    n_integ_points_thresh: int = 8
    heatmap_peak_thresh: float = 0.05
    inner_product_thresh: float = 0.05
    limb_length_ratio: float = 1.0
    length_penalty_value: float = 1.0
    n_subset_limbs_thresh: int = 3
    subset_score_thresh: float = 0.2
    # Static capacities: peaks per joint and person subsets per image.
    max_peaks_per_joint: int = 32
    max_subsets: int = 64
    # Precise mode: build the scale pyramid on the device from one upload
    # of the original image (False, the host pyramid, is not ported).
    device_pyramid: bool = True
    # Run the two smallest precise-mode scales as one batch-2 forward at
    # the larger one's padded geometry.
    fuse_small_scales: bool = False
    # Cap on the precise-mode postprocess resolution's long side (0 = the
    # original image resolution).
    max_postprocess_len: int = 0
    # Mean RGB padding value of the precise-mode canvas.
    pad_value: Tuple[int, int, int] = (104, 117, 123)
    # After ``PoseDetector.quantize()``, forwards whose network input's
    # short side is below this stay float32 (0 = quantize every geometry).
    quant_min_side: int = 256


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the reference trainer's)."""

    insize: int = 368
    downscale: int = 8
    paf_sigma: float = 8.0       # half-width of the constant PAF band
    heatmap_sigma: float = 7.0   # GT heatmap gaussian sigma

    min_keypoints: int = 5
    min_area: float = 32 * 32

    min_box_size: float = 64.0
    max_box_size: float = 512.0
    min_scale: float = 0.5
    max_scale: float = 2.0
    max_rotate_degree: float = 40.0
    center_perturb_max: float = 40.0

    batch_size: int = 10
    lr: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    # LR schedule: 1e-4 -> 1e-5 at step 100k -> 1e-6 at 200k.
    lr_drop_steps: Tuple[int, ...] = (100_000, 200_000)
    lr_drop_factor: float = 0.1
    iterations: int = 300_000
    # The VGG stem is frozen for the first N steps.
    stem_freeze_steps: int = 2000
    # Gradient scale of the 12 stem layers.
    stem_grad_scale: float = 0.25
    # Dilation kernel of the ignore mask.
    mask_dilate_ksize: int = 16
    # Most persons rendered into one image's GT maps (a static bound).
    max_persons: int = 16

    snapshot_interval: int = 1000
    log_interval: int = 20

    # Recompute the forward's activations in the backward pass
    # (``torch.utils.checkpoint``).
    remat: bool = False

    # Render the GT maps at the stage output resolution instead of at the
    # input resolution followed by the loss's align-corners downsample:
    # the same bilinear weights on the analytic maps, ~1e-7 apart.
    gt_at_output_res: bool = True


@dataclasses.dataclass(frozen=True)
class FaceConfig:
    """Face keypoint inference parameters."""

    img_size: int = 368
    heatmap_peak_thresh: float = 0.1
    crop_scale: float = 1.5
    gaussian_sigma: float = 2.5
    num_keypoints: int = 70  # + 1 background channel in the net output


@dataclasses.dataclass(frozen=True)
class HandConfig:
    """Hand keypoint inference parameters."""

    img_size: int = 368
    heatmap_peak_thresh: float = 0.1
    gaussian_sigma: float = 2.5
    num_keypoints: int = 21  # + 1 background channel in the net output


INFERENCE = InferenceConfig()
TRAIN = TrainConfig()
FACE = FaceConfig()
HAND = HandConfig()
