"""Multi-stage masked MSE loss of CPM training (port of
``tpupose/train/loss.py``).

* GT maps arrive at the stage output resolution (``gt_at_output_res``) or
  at the input resolution, and are then resized to it with Chainer's
  align-corners bilinear ``resize_chainer``.
* The ignore mask is resized the same way and re-binarized with ``> 0``.
* At masked pixels the GT is the detached prediction, so the squared error
  and its gradient there are exactly zero.
* Each stage's loss is ``mean((pred - gt) ** 2)`` over all its elements;
  the total sums stages and branches.

Maps keep the models' (S, B, h, w, C) layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpupose_torch.ops.resize import resize_chainer


def _prepare_mask(ignore_mask: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    if tuple(ignore_mask.shape[1:3]) != tuple(out_hw):
        return resize_chainer(ignore_mask.float()[..., None],
                              out_hw)[..., 0] > 0
    return ignore_mask > 0


def _masked_stage_losses(ys: torch.Tensor, gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """(S, B, h, w, C) predictions, (B, h, w, C) GT, (B, h, w) mask ->
    (S,) per-stage means of the squared error."""
    gt = torch.where(mask[None, :, :, :, None], ys.detach(), gt[None])
    return ((ys - gt) ** 2).mean(dim=(1, 2, 3, 4))


def compute_loss(pafs_ys: torch.Tensor, heatmaps_ys: torch.Tensor,
                 pafs_t: torch.Tensor, heatmaps_t: torch.Tensor,
                 ignore_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pafs_ys / heatmaps_ys: (S, B, h, w, C) stacked stage outputs;
    pafs_t / heatmaps_t: (B, H, W, C) GT; ignore_mask: (B, H, W).

    Returns (total, metrics) with the per-branch stage sums the reference
    logs as ``main/paf`` and ``main/heat``."""
    out_hw = tuple(pafs_ys.shape[2:4])
    if tuple(pafs_t.shape[1:3]) != out_hw:
        pafs_t = resize_chainer(pafs_t, out_hw)
        heatmaps_t = resize_chainer(heatmaps_t, out_hw)
    mask = _prepare_mask(ignore_mask, out_hw)
    paf_losses = _masked_stage_losses(pafs_ys, pafs_t, mask)
    heat_losses = _masked_stage_losses(heatmaps_ys, heatmaps_t, mask)
    paf, heat = paf_losses.sum(), heat_losses.sum()
    total = paf + heat
    return total, {"loss": total, "paf": paf, "heat": heat,
                   "paf_stages": paf_losses, "heat_stages": heat_losses}


def compute_loss_single(heatmaps_ys: torch.Tensor, heatmaps_t: torch.Tensor,
                        ignore_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The same masked multi-stage MSE for the single-branch nets (FaceNet,
    HandNet): one stacked heatmap tensor.  The metrics keep a ``paf`` key
    (always 0), so logging is the same for every arch."""
    out_hw = tuple(heatmaps_ys.shape[2:4])
    if tuple(heatmaps_t.shape[1:3]) != out_hw:
        heatmaps_t = resize_chainer(heatmaps_t, out_hw)
    mask = _prepare_mask(ignore_mask, out_hw)
    heat_losses = _masked_stage_losses(heatmaps_ys, heatmaps_t, mask)
    total = heat_losses.sum()
    return total, {"loss": total, "paf": torch.zeros_like(total),
                   "heat": total, "paf_stages": torch.zeros_like(heat_losses),
                   "heat_stages": heat_losses}
