"""PAF line-integral limb scoring + greedy 1:1 matching (port of
``tpupose/ops/paf.py``).

The JAX version ``vmap``s one limb's work over the 19 limbs, and
``detect_batch`` ``vmap``s the frame's over frames; here both axes are
written out as leading dimensions: every function takes ``(..., L, ...)``
tensors, a frame axis or none in front of the limbs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpupose_torch.config import InferenceConfig
from tpupose_torch.ops import library
from tpupose_torch.ops.peaks import Peaks
from tpupose_torch.ops.upload import to_device


class Connections(NamedTuple):
    """Static-shape accepted connections per limb.

    a_slot, b_slot: (..., L, K) int64 peak slots (-1 when the entry is
                    unused)
    score:          (..., L, K) float32 connection integral score
    valid:          (..., L, K) bool, accepted connections first, in greedy
                    acceptance order (descending score)
    """

    a_slot: torch.Tensor
    b_slot: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def score_candidates(paf_rows: torch.Tensor, hw, ax, ay, a_valid,
                     bx, by, b_valid, img_len: float,
                     cfg: InferenceConfig):
    """Dense candidate scores for all limbs at once.

    paf_rows: (N, H*W, 2) per-pixel (x, y) PAF components of each of N
    limbs (a batch's frames x limbs flattened).  hw: (H, W).  ax..b_valid:
    (N, K) endpoint peak tables of each limb.  Returns (scores, valid):
    (N, K, K) with rows = joint_a candidates.
    """
    n_limbs, k = ax.shape
    h, w = hw
    n_pts = cfg.n_integ_points

    vx = bx[:, None, :] - ax[:, :, None]          # (L, K, K)
    vy = by[:, None, :] - ay[:, :, None]
    norm = torch.sqrt(vx * vx + vy * vy)
    nonzero = norm > 0
    safe_norm = torch.where(nonzero, norm, torch.ones_like(norm))
    ux, uy = vx / safe_norm, vy / safe_norm

    # Sample points: linspace built once on the host (so every device sees
    # the same float32 values), rounded half to even like np.round.
    t = to_device(torch.linspace(0.0, 1.0, n_pts), paf_rows.device)
    xs = ax[:, :, None, None] + vx[..., None] * t   # (L, K, K, P)
    ys = ay[:, :, None, None] + vy[..., None] * t
    xi = torch.round(xs).long().clamp(0, w - 1)
    yi = torch.round(ys).long().clamp(0, h - 1)
    flat_idx = (yi * w + xi).reshape(n_limbs, -1)  # (L, K*K*P)

    # One (HW, 2) row gather per sample returns both PAF components.
    got = torch.gather(paf_rows, 1,
                       flat_idx[..., None].expand(-1, -1, 2))
    got = got.reshape(n_limbs, k, k, n_pts, 2)
    inner = got[..., 0] * ux[..., None] + got[..., 1] * uy[..., None]

    integ = inner.mean(dim=-1)
    penalty = torch.clamp(
        cfg.limb_length_ratio * img_len / safe_norm
        - cfg.length_penalty_value, max=0.0)
    score = integ + penalty

    n_valid_pts = (inner > cfg.inner_product_thresh).sum(dim=-1)
    valid = (nonzero
             & (n_valid_pts > cfg.n_integ_points_thresh)
             & (score > 0.0)
             & a_valid[:, :, None]
             & b_valid[:, None, :])
    return score, valid


def greedy_match(score: torch.Tensor, valid: torch.Tensor,
                 n_a: torch.Tensor, n_b: torch.Tensor):
    """Greedy 1:1 matching for every limb (ref ``pose_detector.py:172-177``),
    the plain version of ``ops/greedy_match.py``'s kernel.

    score/valid: (..., K, K); n_a, n_b: (...), one entry per limb (of each
    frame).  Candidates are taken in descending score with ties in a-major
    enumeration order, skipping used endpoints, until ``min(n_a, n_b)`` are
    accepted.  Taking the best still-free candidate K times is the same:
    each step is one masked argmax per limb (``torch.argmax`` returns the
    first maximum, the a-major tie-break), with no host sync.  Returns
    (a_slot, b_slot, score, valid): (..., K) each.
    """
    lead, k = score.shape[:-2], score.shape[-1]
    score = score.reshape(-1, k, k)
    valid = valid.reshape(-1, k, k)
    n_a, n_b = n_a.reshape(-1), n_b.reshape(-1)
    n_limbs = score.shape[0]
    dev = score.device
    flat_valid = valid.reshape(n_limbs, k * k)
    neg_inf = torch.full((), -float("inf"), device=dev)
    flat_score = torch.where(flat_valid, score.reshape(n_limbs, k * k),
                             neg_inf)
    max_conn = torch.minimum(n_a, n_b)
    slots = torch.arange(k, device=dev)
    used_a = torch.zeros((n_limbs, k), dtype=torch.bool, device=dev)
    used_b = torch.zeros_like(used_a)
    done = torch.zeros(n_limbs, dtype=torch.bool, device=dev)
    n_taken = torch.zeros(n_limbs, dtype=torch.long, device=dev)
    out_a = torch.full((n_limbs, k), -1, dtype=torch.long, device=dev)
    out_b = torch.full_like(out_a, -1)
    out_s = torch.zeros((n_limbs, k), dtype=torch.float32, device=dev)
    for _ in range(k):
        free = flat_valid & ~(used_a[:, :, None] | used_b[:, None, :]
                              ).reshape(n_limbs, k * k)
        free_score = torch.where(free, flat_score, neg_inf)
        pos = torch.argmax(free_score, dim=1)
        best = torch.gather(free_score, 1, pos[:, None])[:, 0]
        take = torch.isfinite(best) & (n_taken < max_conn) & ~done
        a = torch.div(pos, k, rounding_mode="floor")
        b = pos % k
        used_a = used_a | ((slots == a[:, None]) & take[:, None])
        used_b = used_b | ((slots == b[:, None]) & take[:, None])
        at = (slots == n_taken[:, None]) & take[:, None]
        out_a = torch.where(at, a[:, None], out_a)
        out_b = torch.where(at, b[:, None], out_b)
        out_s = torch.where(at, best[:, None], out_s)
        n_taken = n_taken + take.long()
        done = done | ~take
    out_valid = slots[None, :] < n_taken[:, None]
    return tuple(t.reshape(*lead, k) for t in (out_a, out_b, out_s,
                                               out_valid))


def compute_connections(pafs: torch.Tensor, peaks: Peaks, img_len: float,
                        cfg: InferenceConfig, limbs_a: np.ndarray,
                        limbs_b: np.ndarray) -> Connections:
    """All-limb candidate scoring + matching.

    pafs: (..., 2*L, H, W) with limb i in channels (2i, 2i+1); peaks:
    (..., J, K) tables of the same frames.  limbs_a/limbs_b: (L,) joint
    indices of each limb's endpoints.
    """
    num_limbs = len(limbs_a)
    hw = tuple(pafs.shape[-2:])
    paf_rows = pafs.reshape(*pafs.shape[:-3], num_limbs, 2, -1).transpose(
        -1, -2)                                  # (..., L, HW, 2)
    return compute_connections_from_rows(paf_rows, hw, peaks, img_len, cfg,
                                         limbs_a, limbs_b)


def compute_connections_from_rows(paf_rows: torch.Tensor, hw, peaks: Peaks,
                                  img_len: float, cfg: InferenceConfig,
                                  limbs_a: np.ndarray,
                                  limbs_b: np.ndarray) -> Connections:
    """``compute_connections`` on PAF sample rows: paf_rows (..., L, H*W,
    2), limb-major (x, y) per pixel; hw: (H, W).  Every frame's limbs are
    scored as one (frames x L) batch, and matched in one call."""
    a_slot, b_slot, score, valid = library.greedy_match(*limb_candidates(
        paf_rows, hw, peaks, img_len, cfg, limbs_a, limbs_b))
    return Connections(a_slot=a_slot, b_slot=b_slot, score=score,
                       valid=valid)


def limb_candidates(paf_rows: torch.Tensor, hw, peaks: Peaks,
                    img_len: float, cfg: InferenceConfig,
                    limbs_a: np.ndarray, limbs_b: np.ndarray):
    """The matcher's inputs: (score, valid) (..., L, K, K) from
    :func:`score_candidates` over every frame's limbs at once, and each
    limb's endpoint counts (n_a, n_b) (..., L)."""
    dev = paf_rows.device
    lead = paf_rows.shape[:-3]
    n_rows = paf_rows.shape[-3] * int(np.prod(lead, dtype=np.int64))
    ia = to_device(np.asarray(limbs_a, np.int64), dev)
    ib = to_device(np.asarray(limbs_b, np.int64), dev)

    def ends(table, index):                      # (..., J, K) -> (N, K)
        return table.index_select(-2, index).reshape(n_rows, -1)

    av, bv = ends(peaks.valid, ia), ends(peaks.valid, ib)
    score, valid = score_candidates(
        paf_rows.reshape(n_rows, *paf_rows.shape[-2:]), tuple(hw),
        ends(peaks.x, ia), ends(peaks.y, ia), av, ends(peaks.x, ib),
        ends(peaks.y, ib), bv, img_len, cfg)
    k = score.shape[-1]
    shape = (*lead, -1)
    return (score.reshape(*shape, k, k), valid.reshape(*shape, k, k),
            av.sum(dim=1).reshape(shape), bv.sum(dim=1).reshape(shape))
