"""Fixed-shape heatmap peak extraction (port of ``tpupose/ops/peaks.py``).

Per joint channel: SciPy-reflect Gaussian blur, then pixels strictly above
the threshold and strictly above their 4 neighbours (out-of-image neighbours
count as 0), gathered into a static ``(J, K)`` table in row-major scan order.
``mode="conv"`` is the reference's GPU branch instead: a zero-padded
``ksize`` Gaussian and the ``>=`` neighbour rule, plain PyTorch on every
device (plain XLA in the JAX package: no kernel backs it).
The face and hand nets take one keypoint per channel instead, its global
argmax (``global_argmax_keypoints``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpupose_torch.ops.blur_nms import nms_mask  # noqa: F401
from tpupose_torch.ops.blur_nms import neighbour_shifts
from tpupose_torch.ops.gaussian import (gaussian_blur_conv_zero,
                                        gaussian_blur_reflect)
from tpupose_torch.ops.library import blur_nms


class Peaks(NamedTuple):
    """Static-shape peak table.

    x, y:    (J, K) float32 peak coordinates (heatmap pixel space)
    score:   (J, K) float32 smoothed-heatmap value at the peak
    valid:   (J, K) bool
    dropped: () int64 — peaks beyond the K capacity (0 = exact reference
             semantics, >0 = a crowd overflowed the table)
    """

    x: torch.Tensor
    y: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    dropped: torch.Tensor


def nms_mask_ge(smoothed: torch.Tensor, thresh: float) -> torch.Tensor:
    """4-neighbour ``>=`` local-max mask with zero borders (the reference's
    GPU rule): ``> thresh`` and ``>=`` each neighbour, so every pixel of a
    plateau is a peak, where ``nms_mask``'s strict rule keeps none."""
    h = smoothed
    up, down, left, right = neighbour_shifts(h)
    return ((h > thresh) & (h >= up) & (h >= down) & (h >= left)
            & (h >= right))


def extract_peaks(mask: torch.Tensor, smoothed: torch.Tensor,
                  max_peaks: int) -> Peaks:
    """Select up to ``max_peaks`` peaks per joint in row-major scan order.

    mask, smoothed: (J, H, W).  Keys are ``hw - scan_idx`` for peaks and 0
    elsewhere, so the top K keys are the first K peaks.  Valid keys are
    unique; the ties among the zero keys, whose order ``torch.topk`` leaves
    open, are masked out.
    """
    j, h, w = mask.shape
    hw = h * w
    flat_mask = mask.reshape(j, hw)
    flat_score = smoothed.reshape(j, hw)
    # float32 keys are exact below 2^24, as in the JAX version.
    key_dtype = torch.float32 if hw < (1 << 24) else torch.int64
    scan_idx = torch.arange(hw, device=mask.device)
    key = torch.where(flat_mask, hw - scan_idx, 0).to(key_dtype)
    k_eff = min(max_peaks, hw)  # degenerate tiny maps: topk needs k <= hw
    top_key, top_idx = torch.topk(key, k_eff, dim=1)
    if k_eff < max_peaks:
        pad = (0, max_peaks - k_eff)
        top_key = torch.nn.functional.pad(top_key, pad)
        top_idx = torch.nn.functional.pad(top_idx, pad)
    valid = top_key > 0
    ys = torch.div(top_idx, w, rounding_mode="floor").float()
    xs = (top_idx % w).float()
    scores = torch.gather(flat_score, 1, top_idx)
    zero = torch.zeros_like(ys)
    return Peaks(
        x=torch.where(valid, xs, zero),
        y=torch.where(valid, ys, zero),
        score=torch.where(valid, scores, zero),
        valid=valid,
        dropped=flat_mask.sum() - valid.sum(),
    )


def find_peaks(heatmaps: torch.Tensor, sigma: float, thresh: float,
               max_peaks: int, mode: str = "scipy", ksize: int = 17) -> Peaks:
    """Blur -> NMS -> static top-K table.

    heatmaps: (J, H, W) *without* the background channel.  ``"scipy"``: the
    fused blur + NMS runs through :func:`blur_nms`, which picks the CUDA
    kernel for a CUDA tensor and the plain version for a CPU one (through
    ``tpupose::blur_nms`` in a traced program); no map-size cut applies.
    ``"conv"``: ``gaussian_blur_conv_zero`` of ``ksize`` and
    ``nms_mask_ge``, plain PyTorch.
    """
    if mode == "conv":
        smoothed = gaussian_blur_conv_zero(heatmaps, sigma, ksize)
        mask = nms_mask_ge(smoothed, thresh)
    elif mode == "scipy":
        smoothed, mask = blur_nms(heatmaps.contiguous(), sigma, thresh)
    else:
        raise ValueError(f"unknown peak NMS mode {mode!r}")
    return extract_peaks(mask, smoothed, max_peaks)


def global_argmax_keypoints(heatmaps: torch.Tensor, sigma: float,
                            thresh: float):
    """One keypoint per channel: the global argmax of the blurred map.

    heatmaps: (C, H, W) *without* the background channel.  Returns
    ``(x, y, score, valid)``, each (C,): int64 coordinates, the blurred
    value there and ``score > thresh``.  The blur is the plain
    ``gaussian_blur_reflect`` on every device (the JAX package runs no
    kernel here either); ties go to the first maximum in row-major order,
    as ``jnp.argmax``'s do.
    """
    smoothed = gaussian_blur_reflect(heatmaps, sigma)
    c, h, w = smoothed.shape
    flat = smoothed.reshape(c, h * w)
    idx = torch.argmax(flat, dim=1)
    score = torch.gather(flat, 1, idx[:, None])[:, 0]
    return (idx % w, torch.div(idx, w, rounding_mode="floor"), score,
            score > thresh)
