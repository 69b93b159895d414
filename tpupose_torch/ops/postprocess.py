"""End-to-end pose postprocessing: heatmaps + PAFs -> pose tables (port of
``tpupose/ops/postprocess.py``).

Blur + NMS, the top-K peak table, PAF scoring, greedy matching, grouping
and the pose table all run on the maps' device; a detector copies the
result to the host once per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpupose_torch.config import LIMBS_FROM, LIMBS_TO, InferenceConfig
from tpupose_torch.ops.grouping import subsets_to_poses
from tpupose_torch.ops.library import group_keypoints
from tpupose_torch.ops.paf import (compute_connections,
                                   compute_connections_from_rows)
from tpupose_torch.ops.peaks import find_peaks


class PoseResult(NamedTuple):
    """poses: (S, 18, 3) [x, y, v]; scores: (S,); valid: (S,) bool;
    num_peaks: () total peak count.

    Saturation counters (0 in any scene within the static capacity, where
    outputs are exactly the reference's): ``peaks_dropped`` = peaks beyond
    K per joint, ``spawns_suppressed`` = person subsets refused by a full
    table."""

    poses: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor
    num_peaks: torch.Tensor
    peaks_dropped: torch.Tensor
    spawns_suppressed: torch.Tensor


def postprocess_pose(pafs: torch.Tensor, heatmaps: torch.Tensor,
                     img_len: float, cfg: InferenceConfig) -> PoseResult:
    """pafs: (38, H, W); heatmaps: (19, H, W), at postprocess resolution.
    ``img_len`` is the map width, used by the PAF distance prior."""
    peaks = _peaks(heatmaps, cfg)
    connections = compute_connections(pafs, peaks, float(img_len), cfg,
                                      LIMBS_FROM, LIMBS_TO)
    return _finish(peaks, connections, cfg)


def postprocess_pose_from_rows(paf_rows: torch.Tensor,
                               heatmaps: torch.Tensor, hw, img_len: float,
                               cfg: InferenceConfig) -> PoseResult:
    """:func:`postprocess_pose` on PAF sample rows: paf_rows (L, H*W, 2),
    limb-major (x, y) per pixel; heatmaps (19, H, W); hw (H, W).  The same
    result, without the (38, H, W) -> rows transpose."""
    peaks = _peaks(heatmaps, cfg)
    connections = compute_connections_from_rows(
        paf_rows, hw, peaks, float(img_len), cfg, LIMBS_FROM, LIMBS_TO)
    return _finish(peaks, connections, cfg)


def _peaks(heatmaps: torch.Tensor, cfg: InferenceConfig):
    return find_peaks(heatmaps[:-1], cfg.gaussian_sigma,
                      cfg.heatmap_peak_thresh, cfg.max_peaks_per_joint,
                      mode=cfg.nms_mode)


def _finish(peaks, connections, cfg: InferenceConfig) -> PoseResult:
    subsets = group_keypoints(connections, peaks, cfg)
    poses, person_valid = subsets_to_poses(subsets, peaks)
    return PoseResult(
        poses=poses,
        scores=torch.where(person_valid, subsets.score, 0.0),
        valid=person_valid,
        num_peaks=peaks.valid.sum(),
        peaks_dropped=peaks.dropped,
        spawns_suppressed=subsets.spawns_suppressed,
    )
