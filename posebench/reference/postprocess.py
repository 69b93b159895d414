"""The pose postprocess of the reference: the original Chainer
implementation's algorithm (``pose_detector.py``), in float32 with each
operation rounded where the port rounds it.

Its steps and their semantics are frozen from ``tests/oracles.py`` (peaks,
candidate connections, greedy matching) and the JAX package's
``ops/grouping.py::group_keypoints_numpy`` (the subset fold, with the
original's quirks): a SciPy-reflect Gaussian blur, peaks strictly above the
threshold and their 4 neighbours (0 outside the map), the first
``max_peaks_per_joint`` of each joint in row-major order; candidate limbs
scored by the PAF at ``n_integ_points`` samples with a length prior; greedy
one-to-one matching by score (ties in a-major order); the fold.

The float32 arithmetic is the port's plain versions' (``ops/gaussian.py``,
``ops/paf.py::score_candidates``, ``ops/grouping.py``), so that two
neighbours a few ulps apart order alike on both sides: with float64 sums
(SciPy, the oracles) a near-tie moved a peak by a pixel, and with it a
person, about once in 25 seeds.  The blur, the matching and the fold run
in numpy; the candidate scores run as torch operations on the maps' device
in the port's shapes, so that the mean over the samples reduces in the
same order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NUM_JOINTS = 18
# (joint a, joint b) of each of the 19 limbs; PAF channels 2l, 2l + 1.
LIMBS = ((1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 2),
         (2, 3), (3, 4), (2, 16), (1, 5), (5, 6), (6, 7), (5, 17), (1, 0),
         (0, 14), (0, 15), (14, 16), (15, 17))
NON_SPAWNING_LIMBS = (9, 13)


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """SciPy's normalized 1-D Gaussian, as float32."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return (phi / phi.sum()).astype(np.float32)


def smooth(maps: np.ndarray, sigma: float) -> np.ndarray:
    """(..., H, W) float32 -> SciPy-reflect Gaussian blur: rows, then
    columns, each pass ``x0 * w0`` then ``acc + xk * wk`` in tap order,
    every product and sum rounded to float32."""
    taps = gaussian_taps(sigma)
    r = (len(taps) - 1) // 2
    x = maps.astype(np.float32)
    h, w = x.shape[-2:]
    xp = x[..., np.pad(np.arange(h), r, mode="symmetric"), :]
    acc = xp[..., 0:h, :] * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xp[..., k:k + h, :] * taps[k]
    yp = acc[..., np.pad(np.arange(w), r, mode="symmetric")]
    out = yp[..., 0:w] * taps[0]
    for k in range(1, len(taps)):
        out = out + yp[..., k:k + w] * taps[k]
    return out


def find_peaks(heatmaps: np.ndarray, p: dict):
    """heatmaps: (18, H, W) float32 without background -> per joint, a list
    of (x, y, score) in row-major order, at most ``max_peaks_per_joint``;
    and the most peaks any joint had."""
    s = smooth(heatmaps, p["gaussian_sigma"])
    zero = np.zeros_like(s[:, :1, :])
    up = np.concatenate([zero, s[:, :-1, :]], 1)
    down = np.concatenate([s[:, 1:, :], zero], 1)
    zero = np.zeros_like(s[:, :, :1])
    left = np.concatenate([zero, s[:, :, :-1]], 2)
    right = np.concatenate([s[:, :, 1:], zero], 2)
    mask = ((s > p["heatmap_peak_thresh"]) & (s > up) & (s > down)
            & (s > left) & (s > right))
    out, most = [], 0
    for j in range(s.shape[0]):
        ys, xs = np.nonzero(mask[j])
        most = max(most, len(ys))
        out.append([(int(x), int(y), s[j, y, x]) for y, x
                    in list(zip(ys, xs))[:p["max_peaks_per_joint"]]])
    return out, most


def candidate_scores(pafs: torch.Tensor, peaks, img_len: float, p: dict):
    """The port's ``score_candidates`` over all limbs at once, on the
    PAFs' device: (score, valid) (19, K, K) float32 numpy, rows the limb's
    joint-a peaks.  pafs: (38, H, W) float32."""
    k = p["max_peaks_per_joint"]
    dev = pafs.device
    h, w = pafs.shape[-2:]
    table = np.zeros((3, NUM_JOINTS, k), np.float32)
    for j, plist in enumerate(peaks):
        for i, (x, y, _) in enumerate(plist):
            table[:, j, i] = (x, y, 1.0)
    table = torch.from_numpy(table).to(dev)
    ia = torch.tensor([a for a, _ in LIMBS], device=dev)
    ib = torch.tensor([b for _, b in LIMBS], device=dev)
    ax, ay, av = (t.index_select(0, ia) for t in table)
    bx, by, bv = (t.index_select(0, ib) for t in table)
    av, bv = av > 0, bv > 0
    rows = pafs.reshape(len(LIMBS), 2, -1).transpose(-1, -2)  # (L, HW, 2)
    n_pts = p["n_integ_points"]

    vx = bx[:, None, :] - ax[:, :, None]
    vy = by[:, None, :] - ay[:, :, None]
    norm = torch.sqrt(vx * vx + vy * vy)
    nonzero = norm > 0
    safe_norm = torch.where(nonzero, norm, torch.ones_like(norm))
    ux, uy = vx / safe_norm, vy / safe_norm
    t = torch.linspace(0.0, 1.0, n_pts).to(dev)
    xs = ax[:, :, None, None] + vx[..., None] * t
    ys = ay[:, :, None, None] + vy[..., None] * t
    xi = torch.round(xs).long().clamp(0, w - 1)
    yi = torch.round(ys).long().clamp(0, h - 1)
    flat = (yi * w + xi).reshape(len(LIMBS), -1)
    got = torch.gather(rows, 1, flat[..., None].expand(-1, -1, 2))
    got = got.reshape(len(LIMBS), k, k, n_pts, 2)
    inner = got[..., 0] * ux[..., None] + got[..., 1] * uy[..., None]
    integ = inner.mean(dim=-1)
    penalty = torch.clamp(p["limb_length_ratio"] * img_len / safe_norm
                          - p["length_penalty_value"], max=0.0)
    score = integ + penalty
    n_valid = (inner > p["inner_product_thresh"]).sum(dim=-1)
    valid = (nonzero & (n_valid > p["n_integ_points_thresh"])
             & (score > 0.0) & av[:, :, None] & bv[:, None, :])
    return score.cpu().numpy(), valid.cpu().numpy()


def connections(score: np.ndarray, valid: np.ndarray, peaks):
    """Per limb, the accepted (slot a, slot b, score) in greedy order:
    candidates by descending score, ties in a-major order, skipping used
    endpoints, until ``min(n_a, n_b)`` are taken."""
    out = []
    for limb, (ja, jb) in enumerate(LIMBS):
        n_a, n_b = len(peaks[ja]), len(peaks[jb])
        ia, ib = np.nonzero(valid[limb])
        cands = sorted(zip(ia.tolist(), ib.tolist(),
                           score[limb][ia, ib].tolist()),
                       key=lambda c: c[2], reverse=True)
        conns, used_a, used_b = [], set(), set()
        for a, b, s in cands:
            if len(conns) >= min(n_a, n_b):
                break
            if a not in used_a and b not in used_b:
                conns.append((a, b, np.float32(s)))
                used_a.add(a)
                used_b.add(b)
        out.append(conns)
    return out


def group(conns, peak_scores: np.ndarray, p: dict):
    """The subset fold in float32; returns the subsets that pass the final
    filter as dicts of ``j`` (18 slots, -1 where absent), ``score`` and
    ``count``."""
    subsets = []
    for limb, limb_conns in enumerate(conns):
        ja, jb = LIMBS[limb]
        for ind_a, ind_b, conn in limb_conns:
            found = [i for i, s in enumerate(subsets)
                     if s["j"][ja] == ind_a or s["j"][jb] == ind_b]
            if len(found) == 1:
                s = subsets[found[0]]
                if s["j"][jb] != ind_b:
                    s["j"][jb] = ind_b
                    s["count"] += np.float32(1)
                    s["score"] += peak_scores[jb, ind_b] + conn
            elif len(found) == 2:
                s1, s2 = subsets[found[0]], subsets[found[1]]
                if not np.any((s1["j"] >= 0) & (s2["j"] >= 0)):
                    s1["j"] = s1["j"] + s2["j"] + 1
                    s1["score"] += s2["score"] + conn
                    # the original adds the connection score to the count
                    s1["count"] += s2["count"] + conn
                    del subsets[found[1]]
                else:
                    for s in (s1, s2):
                        if s["j"][ja] == -1:
                            s["j"][ja] = ind_a
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[ja, ind_a] + conn
                        elif s["j"][jb] == -1:
                            s["j"][jb] = ind_b
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[jb, ind_b] + conn
            elif len(found) == 0 and limb not in NON_SPAWNING_LIMBS:
                j = -np.ones(NUM_JOINTS, np.int64)
                j[ja], j[jb] = ind_a, ind_b
                subsets.append({"j": j, "count": np.float32(2),
                                "score": (peak_scores[ja, ind_a]
                                          + peak_scores[jb, ind_b] + conn)})
    thresh = np.float32(p["subset_score_thresh"])
    return [s for s in subsets
            if s["count"] >= p["n_subset_limbs_thresh"]
            and s["score"] / s["count"] >= thresh]


def poses(pafs: torch.Tensor, heatmaps: np.ndarray, p: dict,
          scale: Tuple[float, float]):
    """Maps at postprocess resolution, PAFs (38, H, W) on a device and
    heatmaps (19, H, W) float32 numpy -> (poses (N, 18, 3) of (x, y, 2) in
    original pixels, scores (N,), the most peaks of any joint, ``scale``:
    original pixels per map pixel)."""
    peaks, most = find_peaks(heatmaps[:-1], p)
    peak_scores = np.zeros((NUM_JOINTS, p["max_peaks_per_joint"]),
                           np.float32)
    for j, plist in enumerate(peaks):
        for i, (_, _, s) in enumerate(plist):
            peak_scores[j, i] = s
    score, valid = candidate_scores(pafs, peaks, float(pafs.shape[-1]), p)
    subsets = group(connections(score, valid, peaks), peak_scores, p)
    out: List[np.ndarray] = []
    for s in subsets:
        pose = np.zeros((NUM_JOINTS, 3), np.float64)
        for j in range(NUM_JOINTS):
            if s["j"][j] >= 0:
                x, y, _ = peaks[j][s["j"][j]]
                pose[j] = (x * scale[0], y * scale[1], 2)
        out.append(pose)
    pose_arr = (np.stack(out) if out
                else np.zeros((0, NUM_JOINTS, 3), np.float64))
    return (pose_arr, np.asarray([s["score"] for s in subsets], np.float32),
            most, scale)
