"""Pose skeletons as values: the parts a net's heatmaps hold, the pairs its
PAFs score, and the pairs that never spawn a person.

A ``Topology`` flows from the architecture (``models.ARCHS[arch].topology``)
through ``PoseDetector`` into the postprocess: the peak tables, candidate
scoring, greedy matching, the grouping fold (its plain version and its
CUDA kernel) and the emitted ``(N, J, 3)`` poses.  Pair ``k`` reads PAF
channels ``2k`` and ``2k + 1``; the heatmaps hold the J parts, then the
background.

- ``COCO18``: CocoPoseNet's 18 joints and 19 limbs, built from the globals
  of ``config.py`` (which stays a copy of the JAX package's);
- ``BODY25``: OpenPose's BODY_25 (``poseParameters.cpp``), 25 parts and 26
  pairs in OpenPose's pair order.  Its PAF channel order is taken as the
  identity (pair k at channels 2k, 2k + 1); OpenPose's own
  ``POSE_MAP_INDEX`` order replaces it once trained weights are loaded.
  As for COCO, the two shoulder-ear pairs (``2-17`` and ``5-18``) never
  spawn a person.
- ``COCO17``: the 17 COCO keypoints of an associative-embedding net
  (HigherHRNet): no PAF pairs and no background channel; COCO's 19-edge
  skeleton to draw, the flip index that mirrors a left part onto its
  right, and the order in which ``match_by_tag`` takes the parts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from tpupose_torch import config


@dataclasses.dataclass(frozen=True)
class Topology:
    """One skeleton: ``parts`` (J names), ``limbs`` ((a, b) part ids of each
    of the L pairs, in PAF channel order) and ``non_spawning`` (pair
    indices that only attach to a person)."""

    name: str
    parts: Tuple[str, ...]
    limbs: Tuple[Tuple[int, int], ...]
    non_spawning: Tuple[int, ...]
    skeleton: Tuple[Tuple[int, int], ...] = ()   # drawn where no PAF pairs
    flip_index: Tuple[int, ...] = ()
    match_order: Tuple[int, ...] = ()

    @property
    def num_joints(self) -> int:
        return len(self.parts)

    @property
    def num_limbs(self) -> int:
        return len(self.limbs)

    @property
    def paf_channels(self) -> int:
        return 2 * len(self.limbs)

    @property
    def heatmap_channels(self) -> int:
        return len(self.parts) + 1   # + background

    @functools.cached_property
    def limbs_from(self) -> np.ndarray:
        return np.asarray([a for a, _ in self.limbs], np.int32)

    @functools.cached_property
    def limbs_to(self) -> np.ndarray:
        return np.asarray([b for _, b in self.limbs], np.int32)

    @functools.cached_property
    def spawns(self) -> Tuple[int, ...]:
        """Per pair, 1 if a connection with no person may start one."""
        return tuple(int(k not in self.non_spawning)
                     for k in range(len(self.limbs)))


COCO18 = Topology(
    name="coco18",
    parts=tuple(j.name for j in config.JointType),
    limbs=tuple((int(a), int(b)) for a, b in config.LIMBS),
    non_spawning=tuple(config.NON_SPAWNING_LIMBS),
)

BODY25_PARTS: Tuple[str, ...] = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
)

# OpenPose's POSE_BODY_25_PAIRS_RENDER order, which is also its PAF pairs'.
BODY25_LIMBS: Tuple[Tuple[int, int], ...] = (
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
    (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
    (15, 17), (0, 16), (16, 18), (2, 17), (5, 18), (14, 19), (19, 20),
    (14, 21), (11, 22), (22, 23), (11, 24),
)

BODY25 = Topology(
    name="body25",
    parts=BODY25_PARTS,
    limbs=BODY25_LIMBS,
    non_spawning=(BODY25_LIMBS.index((2, 17)), BODY25_LIMBS.index((5, 18))),
)


COCO17_PARTS: Tuple[str, ...] = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)

COCO17 = Topology(
    name="coco17",
    parts=COCO17_PARTS,
    limbs=(),
    non_spawning=(),
    # COCO's skeleton (person_keypoints annotations), 0-based
    skeleton=((15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
              (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
              (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6)),
    flip_index=(0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15),
    # HigherHRNet's Params.joint_order, 0-based
    match_order=(0, 1, 2, 3, 4, 5, 6, 11, 12, 7, 8, 9, 10, 13, 14, 15, 16),
)


def from_tables(num_joints: int, limbs_from, limbs_to, spawns) -> Topology:
    """A topology from the integer tables a traced program carries (the
    ``tpupose::group_keypoints`` op's arguments); parts are unnamed."""
    return Topology(
        name="tables",
        parts=tuple(f"part{j}" for j in range(int(num_joints))),
        limbs=tuple((int(a), int(b)) for a, b in zip(limbs_from, limbs_to)),
        non_spawning=tuple(k for k, s in enumerate(spawns) if not s))
