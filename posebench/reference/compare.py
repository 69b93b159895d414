"""The numbers that decide ``correct``: every answer the program gave,
against the reference's answer to the same input.

The reference rounds its postprocess where the port does, so sound runs
agree exactly; a joint or keypoint one map pixel away still matches, as a
cushion for a near-tie that rounds the other way, and a wrong answer moves
it further, drops it or joins it to another person.  A repeated input
counts once, by its worst answer.

Two numbers a cell, each held to its own limit: what is missing or moved,
and the score gap of what matched.

Poses: ``persons_unmatched`` counts the persons of either side with no
counterpart (the same joints, each within one map pixel), summed over the
inputs; ``score_rel_gap`` is the largest relative gap between the scores
of a program person and its counterpart, 0 where none matched.

Hand keypoints: ``keypoints_moved`` counts the keypoints present on one
side only or further than one crop pixel from their counterpart, summed
over the inputs; ``score_rel_gap`` is the largest relative score gap of a
keypoint within one crop pixel of its counterpart.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

EXACT_PX = 0.01


def _same_pose(a: np.ndarray, b: np.ndarray, tol: Tuple[float, float]
               ) -> bool:
    present = a[:, 2] > 0
    if not np.array_equal(present, b[:, 2] > 0):
        return False
    d = np.abs(a[present, :2] - b[present, :2])
    return bool(np.all(d[:, 0] <= tol[0]) and np.all(d[:, 1] <= tol[1]))


def _pair_persons(pp, rp, tol):
    """Greedy one-to-one pairs (program index, reference index) within
    ``tol``, in the program's order."""
    pairs, used = [], set()
    for a in range(len(pp)):
        hit = next((b for b in range(len(rp))
                    if b not in used and _same_pose(pp[a], rp[b], tol)), None)
        if hit is not None:
            used.add(hit)
            pairs.append((a, hit))
    return pairs


def pose_numbers(answered, want) -> dict:
    """``answered``: (input, (poses, scores, ...)) per answer given;
    ``want``: the reference's (poses, scores, most peaks, (scale x, scale
    y)) per input, scale being original pixels per map pixel."""
    worst: Dict[int, int] = {}
    near: Dict[int, int] = {}
    err = 0.0
    for i, (pp, ps, *_) in answered:
        rp, rs, _, scale = want[i]
        exact = _pair_persons(pp, rp, (EXACT_PX, EXACT_PX))
        rest_p = [a for a in range(len(pp)) if a not in {a for a, _ in exact}]
        rest_r = [b for b in range(len(rp)) if b not in {b for _, b in exact}]
        tol = (scale[0] + EXACT_PX, scale[1] + EXACT_PX)
        close = [(rest_p[a], rest_r[b]) for a, b in
                 _pair_persons(pp[rest_p], rp[rest_r], tol)]
        for a, b in exact + close:
            err = max(err, _rel(ps[a], rs[b]))
        unmatched = len(rest_p) + len(rest_r) - 2 * len(close)
        worst[i] = max(worst.get(i, 0), unmatched)
        near[i] = max(near.get(i, 0), len(close))
    return {"score_rel_gap": err, "persons_unmatched": sum(worst.values()),
            "persons_one_pixel_off": sum(near.values()),
            "reference_persons": sum(len(want[i][0]) for i in worst)}


def keypoint_numbers(answered, want) -> dict:
    """``answered``: (input, per crop keypoint lists) per answer given;
    ``want``: the reference's per crop keypoint lists per input.  A crop
    the program left unanswered has no keypoint."""
    worst: Dict[int, int] = {}
    near: Dict[int, int] = {}
    err = 0.0
    for i, prog in answered:
        moved = close = 0
        for c, rc in enumerate(want[i]):
            pc = prog[c] if c < len(prog) else [None] * len(rc)
            for a, b in zip(pc, rc, strict=True):
                if a is None and b is None:
                    continue
                if a is None or b is None or max(abs(a[0] - b[0]),
                                                 abs(a[1] - b[1])) > 1:
                    moved += 1
                    continue
                close += (a[0], a[1]) != (b[0], b[1])
                err = max(err, _rel(a[2], b[2]))
        worst[i] = max(worst.get(i, 0), moved)
        near[i] = max(near.get(i, 0), close)
    return {"score_rel_gap": err, "keypoints_moved": sum(worst.values()),
            "keypoints_one_pixel_off": sum(near.values()),
            "reference_keypoints": sum(k is not None for i in worst
                                       for crop in want[i] for k in crop)}


def _rel(got, ref) -> float:
    return min(1.0, abs(float(got) - float(ref))
               / max(abs(float(ref)), 1e-12))
