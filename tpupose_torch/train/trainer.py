"""The train and eval steps (port of ``tpupose/train/trainer.py``).

One step runs eagerly on the model's device: the batch of u8 images, padded
pose tables and ignore masks goes to the device, the images are
normalised to ``/255 - 0.5``, the model runs (in its compute dtype), the
GT heatmaps and PAFs are rendered on the device at the stage output
resolution (``data.gt``), the masked multi-stage MSE (``train.loss``) runs
backward, and ``ChainerAdam`` (``train.optimizer``) updates the
parameters.  ``cfg.remat`` recomputes the forward's activations in the
backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint(forward)``
does in the JAX trainer).  Data parallelism (the JAX trainer's mesh) is
ROADMAP item 1.16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpupose_torch.config import TRAIN, TrainConfig
from tpupose_torch.data.gt import (render_heatmaps, render_heatmaps_at,
                                   render_labels, render_labels_at)
from tpupose_torch.train.loss import compute_loss, compute_loss_single
from tpupose_torch.train.optimizer import ChainerAdam, make_optimizer
from tpupose_torch.weights import load_flax_params


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters on the training device)
    and its optimizer."""

    step: int
    model: nn.Module
    optimizer: ChainerAdam


@dataclasses.dataclass
class TrainBatch:
    """``imgs`` uint8 (B, H, W, 3) BGR; ``poses`` (B, P, K, 3) float32
    padded pose tables (v = 0 rows are unlabeled); ``ignore_mask``
    (B, H, W) bool."""

    imgs: torch.Tensor
    poses: torch.Tensor
    ignore_mask: torch.Tensor

    def to(self, device, non_blocking: bool = False) -> "TrainBatch":
        return TrainBatch(*(t.to(device, non_blocking=non_blocking)
                            for t in (self.imgs, self.poses,
                                      self.ignore_mask)))


def training_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (training never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"training on {device}: CUDA is not available "
                           "(pass device='cpu' to train on the CPU)")
    return device


def preprocess_imgs(imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NHWC, ``/255 - 0.5``."""
    return imgs_u8.float() / 255.0 - 0.5


def init_train_state(model: nn.Module, cfg: TrainConfig = TRAIN,
                     arch: str = "posenet", params=None,
                     device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (after loading ``params``, a Flax param
    tree, when given: the ``--initmodel`` warm start) and build its
    optimizer."""
    device = training_device(device)
    if params is not None:
        load_flax_params(model, params)
    model.to(device).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, cfg, arch=arch))


def _gt_nhwc(maps: torch.Tensor) -> torch.Tensor:
    return maps.permute(0, 2, 3, 1)


@torch.no_grad()
def render_batch_labels(batch: TrainBatch, cfg: TrainConfig,
                        out_hw: Optional[Tuple[int, int]] = None):
    """(pafs, heatmaps) GT, (B, h, w, C), for a batch of 18-joint tables;
    at ``out_hw`` when given (``render_labels_at``)."""
    h, w = batch.imgs.shape[1:3]
    if out_hw is not None and tuple(out_hw) != (h, w):
        pafs, heatmaps = render_labels_at(batch.poses, h, w, tuple(out_hw),
                                          cfg.heatmap_sigma, cfg.paf_sigma)
    else:
        pafs, heatmaps = render_labels(batch.poses, h, w, cfg.heatmap_sigma,
                                       cfg.paf_sigma)
    return _gt_nhwc(pafs), _gt_nhwc(heatmaps)


@torch.no_grad()
def render_batch_heatmaps(batch: TrainBatch, cfg: TrainConfig,
                          out_hw: Optional[Tuple[int, int]] = None):
    """Heatmap GT (B, h, w, K + 1) for the single-branch nets' (B, P, K, 3)
    keypoint tables (K = 70 face, 21 hand)."""
    h, w = batch.imgs.shape[1:3]
    if out_hw is not None and tuple(out_hw) != (h, w):
        heatmaps = render_heatmaps_at(batch.poses, h, w, tuple(out_hw),
                                      cfg.heatmap_sigma)
    else:
        heatmaps = render_heatmaps(batch.poses, h, w, cfg.heatmap_sigma)
    return _gt_nhwc(heatmaps)


def loss_for_batch(model: nn.Module, batch: TrainBatch, cfg: TrainConfig):
    """(total, metrics) of ``model`` on ``batch`` (already on the model's
    device)."""
    x = preprocess_imgs(batch.imgs)
    if cfg.remat and torch.is_grad_enabled():
        outs = checkpoint(model, x, use_reentrant=False)
    else:
        outs = model(x)
    if isinstance(outs, tuple):  # CocoPoseNet: (pafs, heatmaps)
        pafs_ys, heatmaps_ys = outs
        out_hw = tuple(pafs_ys.shape[2:4]) if cfg.gt_at_output_res else None
        pafs_t, heatmaps_t = render_batch_labels(batch, cfg, out_hw=out_hw)
        return compute_loss(pafs_ys, heatmaps_ys, pafs_t, heatmaps_t,
                            batch.ignore_mask)
    out_hw = tuple(outs.shape[2:4]) if cfg.gt_at_output_res else None
    heatmaps_t = render_batch_heatmaps(batch, cfg, out_hw=out_hw)
    return compute_loss_single(outs, heatmaps_t, batch.ignore_mask)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(cfg: TrainConfig = TRAIN):
    """``step(state, batch) -> (state, metrics)``: one optimizer step on
    ``batch`` (host or device tensors), ``state`` updated in place; the
    metrics are detached device scalars and per-stage vectors."""

    def step_fn(state: TrainState, batch: TrainBatch):
        batch = batch.to(_device_of(state.model), non_blocking=True)
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_for_batch(state.model, batch, cfg)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_step(cfg: TrainConfig = TRAIN):
    """``eval_step(model, batch) -> metrics``: the validation loss."""

    @torch.no_grad()
    def eval_fn(model: nn.Module, batch: TrainBatch):
        batch = batch.to(_device_of(model), non_blocking=True)
        _, metrics = loss_for_batch(model, batch, cfg)
        return metrics

    return eval_fn


def pad_poses(pose_list, max_persons: int,
              num_keypoints: int = 18) -> np.ndarray:
    """Host helper: a list of (P_i, K, 3) arrays -> (B, max_persons, K, 3)
    with zero rows (v = 0: ignored by the renderers)."""
    batch = np.zeros((len(pose_list), max_persons, num_keypoints, 3),
                     np.float32)
    for i, poses in enumerate(pose_list):
        n = min(len(poses), max_persons)
        if n:
            batch[i, :n] = poses[:n]
    return batch
