"""Native COCO keypoint evaluation: OKS matching + AP/AR summarization
(a copy of ``tpupose/evaluation.py``, which is numpy only).

The reference has eval-mode data loading but NO AP script
(``/root/reference/coco_data_loader.py:21-22,307-308``; SURVEY.md section 6
requires the new framework to add the harness).  This module implements the
COCO keypoint metric natively (no pycocotools): per-pair OKS with the
standard 17-keypoint sigmas, greedy score-ordered matching per OKS
threshold, and 101-point interpolated AP over thresholds .5:.05:.95 with
medium/large area ranges — the same protocol as the official evaluator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tpupose_torch.config import COCO_JOINT_ORDER

# Official COCO keypoint sigmas (person, 17 kpts).
KPT_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089])

OKS_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 20


def pose18_to_coco17(pose: np.ndarray) -> np.ndarray:
    """Internal 18-joint pose (18, 3) -> COCO 17-kpt (17, 3); drops the
    synthesized neck (inverse of the mapping at ``entity.py:106-124``)."""
    kpts = np.zeros((17, 3), np.float64)
    for coco_idx, joint in enumerate(COCO_JOINT_ORDER):
        kpts[coco_idx] = pose[joint]
    return kpts


def poses_to_results(poses: np.ndarray, scores: Sequence[float],
                     img_id: int) -> List[dict]:
    """Detector output -> COCO result dicts (category person=1).

    Keypoint confidence column becomes 1 for present joints; the detection
    score is the mean subset score per joint as the ranking key.
    """
    results = []
    for pose, score in zip(poses, scores):
        kpts = pose18_to_coco17(pose)
        n = max(1, int((pose[:, 2] > 0).sum()))
        # keypoint-extent bbox area over ALL 17 slots including the (0, 0)
        # placeholders of absent joints — exactly pycocotools' loadRes
        # derivation for keypoint results (the area-range ignore rule uses
        # it, so matching the quirk matters for AP_medium/AP_large parity)
        xs_, ys_ = kpts[:, 0], kpts[:, 1]
        area = float((xs_.max() - xs_.min()) * (ys_.max() - ys_.min()))
        results.append({
            "image_id": int(img_id),
            "category_id": 1,
            "keypoints": [
                float(v) for row in kpts
                for v in (row[0], row[1], 1 if row[2] > 0 else 0)],
            "score": float(score) / n,
            "area": area,
        })
    return results


def compute_oks(dt_kpts: np.ndarray, gt: dict) -> float:
    """Object keypoint similarity between one detection (17, 3) and one GT
    annotation (official ``computeOks`` semantics)."""
    variances = (KPT_SIGMAS * 2.0) ** 2
    g = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
    xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
    xd, yd = dt_kpts[:, 0], dt_kpts[:, 1]
    area = float(gt.get("area", 1.0))
    visible = vg > 0
    if visible.sum() > 0:
        d2 = (xd - xg) ** 2 + (yd - yg) ** 2
        e = d2 / variances / (area + np.spacing(1)) / 2.0
        return float(np.mean(np.exp(-e[visible])))
    # no labeled keypoints: distance to the 2x-expanded gt bbox
    bb = gt.get("bbox", [0.0, 0.0, 0.0, 0.0])
    x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
    y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
    dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
    dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
    e = (dx ** 2 + dy ** 2) / variances / (area + np.spacing(1)) / 2.0
    return float(np.mean(np.exp(-e)))


class _ImgEval:
    __slots__ = ("dt_scores", "dt_matches", "dt_ignore", "n_gt")

    def __init__(self, dt_scores, dt_matches, dt_ignore, n_gt):
        self.dt_scores = dt_scores
        self.dt_matches = dt_matches
        self.dt_ignore = dt_ignore
        self.n_gt = n_gt


def _compute_ious(dts: List[dict], gts: List[dict]) -> np.ndarray:
    """OKS matrix for score-sorted dts x original-order gts; computed once
    per image and reused across area ranges (official computeIoU does the
    same — OKS is range-independent)."""
    ious = np.zeros((len(dts), len(gts)))
    for i, dt in enumerate(dts):
        kpts = np.asarray(dt["keypoints"], np.float64).reshape(-1, 3)
        for j, gt in enumerate(gts):
            ious[i, j] = compute_oks(kpts, gt)
    return ious


def _sort_dts(dts: List[dict]) -> List[dict]:
    order = np.argsort([-d["score"] for d in dts], kind="stable")
    return [dts[i] for i in order][:MAX_DETS]


def _evaluate_image(dts: List[dict], gts: List[dict], area_range,
                    ious: Optional[np.ndarray] = None
                    ) -> Optional[_ImgEval]:
    """Greedy per-threshold matching for one image (``evaluateImg``
    semantics: score-ordered dts, each takes the best still-unmatched gt
    with OKS above threshold; ignored gts only match when nothing real
    does, and such dts are ignored rather than counted as FP).

    ``dts`` must already be score-sorted/truncated (``_sort_dts``) when a
    precomputed ``ious`` matrix is supplied.
    """
    if ious is None:
        dts = _sort_dts(dts)
        ious = _compute_ious(dts, gts)
    if not dts and not gts:
        return None
    # inclusive bounds: official COCOeval ignores area < lo or area > hi
    gt_ignore = np.array([
        1 if (g.get("iscrowd", 0) or g.get("num_keypoints", 0) == 0
              or not (area_range[0] <= g.get("area", 0) <= area_range[1]))
        else 0
        for g in gts], np.int32)
    # sort gts: unignored first (stable), as the official evaluator does
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in gt_order]
    gt_ignore = gt_ignore[gt_order]
    ious = ious[:, gt_order] if len(gts) else ious

    is_crowd = np.array([int(bool(g.get("iscrowd", 0))) for g in gts],
                        np.int32)
    T = len(OKS_THRESHOLDS)
    dt_matches = np.zeros((T, len(dts)), np.int32)
    dt_ignore = np.zeros((T, len(dts)), np.int32)
    for ti, thr in enumerate(OKS_THRESHOLDS):
        gt_matched = np.zeros(len(gts), bool)
        for di in range(len(dts)):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi in range(len(gts)):
                # crowd gts stay re-matchable by multiple detections
                # (official evaluateImg semantics)
                if gt_matched[gi] and not is_crowd[gi]:
                    continue
                # once matched to a real gt, don't switch to an ignored one
                if best > -1 and gt_ignore[best] == 0 and gt_ignore[gi] == 1:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            gt_matched[best] = True
            dt_matches[ti, di] = 1
            dt_ignore[ti, di] = gt_ignore[best]
        # unmatched detections whose (keypoint-bbox) area is outside the
        # range are ignored, not false positives (official dtIg rule)
        for di, dt in enumerate(dts):
            if dt_matches[ti, di] == 0 and "area" in dt and not (
                    area_range[0] <= dt["area"] <= area_range[1]):
                dt_ignore[ti, di] = 1
    return _ImgEval(
        dt_scores=np.array([d["score"] for d in dts]),
        dt_matches=dt_matches,
        dt_ignore=dt_ignore,
        n_gt=int((gt_ignore == 0).sum()),
    )


def _accumulate(per_image: List[Optional[_ImgEval]]) -> Dict[str, float]:
    """Precision/recall accumulation with 101-point interpolation."""
    evals = [e for e in per_image if e is not None]
    T = len(OKS_THRESHOLDS)
    recall_thrs = np.linspace(0, 1, 101)
    n_gt = sum(e.n_gt for e in evals)
    if n_gt == 0:
        # official cocoeval reports -1 for undefined metrics; keep the
        # key schema identical to the populated case
        return {"AP": -1.0, "AP50": -1.0, "AP75": -1.0, "AR": -1.0}
    scores = np.concatenate([e.dt_scores for e in evals]) if evals \
        else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    ap_per_t = np.zeros(T)
    ar_per_t = np.zeros(T)
    for ti in range(T):
        matches = np.concatenate(
            [e.dt_matches[ti] for e in evals])[order] if evals else \
            np.zeros(0)
        ignored = np.concatenate(
            [e.dt_ignore[ti] for e in evals])[order] if evals else \
            np.zeros(0)
        keep = ignored == 0
        tp = np.cumsum(matches[keep] == 1)
        fp = np.cumsum(matches[keep] == 0)
        if len(tp) == 0:
            continue
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, np.spacing(1))
        # monotone non-increasing envelope
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        inds = np.searchsorted(recall, recall_thrs, side="left")
        q = np.zeros(len(recall_thrs))
        for ri, pi in enumerate(inds):
            if pi < len(precision):
                q[ri] = precision[pi]
        ap_per_t[ti] = q.mean()
        ar_per_t[ti] = recall[-1]
    return {
        "AP": float(ap_per_t.mean()),
        "AP50": float(ap_per_t[0]),
        "AP75": float(ap_per_t[5]),
        "AR": float(ar_per_t.mean()),
    }


class KeypointEvaluator:
    """Accumulates per-image detections/GT and summarizes COCO-style AP."""

    def __init__(self):
        self._images: Dict[str, List[Optional[_ImgEval]]] = {
            k: [] for k in AREA_RANGES}

    def add_image(self, dts: List[dict], gts: List[dict]) -> None:
        dts = _sort_dts(dts)
        ious = _compute_ious(dts, gts)  # OKS once, reused per range
        for name, rng in AREA_RANGES.items():
            self._images[name].append(_evaluate_image(dts, gts, rng, ious))

    def summarize(self) -> Dict[str, float]:
        out = {}
        for name in AREA_RANGES:
            stats = _accumulate(self._images[name])
            if name == "all":
                out.update(stats)
            else:
                out[f"AP_{name}"] = stats["AP"]
        return out
