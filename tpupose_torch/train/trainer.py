"""The train and eval steps (port of ``tpupose/train/trainer.py``).

One step runs eagerly on the model's device: the batch of u8 images, padded
pose tables and ignore masks goes to the device, the images are
normalised to ``/255 - 0.5``, the model runs (in its compute dtype), the
GT heatmaps and PAFs are rendered on the device at the stage output
resolution (``data.gt``), the masked multi-stage MSE (``train.loss``) runs
backward, and ``ChainerAdam`` (``train.optimizer``) updates the
parameters.  ``cfg.remat`` recomputes the forward's activations in the
backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint(forward)``
does in the JAX trainer).

On a mesh (``tpupose_torch/parallel``; the JAX trainer's ``mesh=``) every
rank runs the step on its part of the batch: ``B / n_data`` samples and a
slab of rows over ``spatial``, the convs exchanging halo rows
(``parallel/spatial.py``).  Each rank renders the GT of its slab's output
rows only, and its loss is its part of the global loss (its sum of
squares over the global element count), so the sum over the ranks is the
one-process loss.  One ``all_reduce(SUM)`` of every gradient in a flat
bucket over the whole world gives each rank the one-process gradient, and
``ChainerAdam`` steps on it, so the parameters stay replicated.  A 1x1
mesh runs the mesh-less step, its collectives over a world of one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils.checkpoint import checkpoint

from tpupose_torch.config import TRAIN, TrainConfig
from tpupose_torch.data.gt import (render_heatmaps, render_heatmaps_at,
                                   render_labels, render_labels_at)
from tpupose_torch.parallel.mesh import Mesh, replicate, shard_batch
from tpupose_torch.parallel.spatial import SpatialSlabs, spatial_halos
from tpupose_torch.train.loss import (prepare_mask, compute_loss,
                                      compute_loss_single)
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
    (B, H, W) bool.  ``sharded``: a mesh rank's part of a global batch
    (``parallel.shard_batch``, the meshed ``BatchLoader``), its rows a
    slab of the image's."""

    imgs: torch.Tensor
    poses: torch.Tensor
    ignore_mask: torch.Tensor
    sharded: bool = False

    def to(self, device, non_blocking: bool = False) -> "TrainBatch":
        return TrainBatch(*(t.to(device, non_blocking=non_blocking)
                            for t in (self.imgs, self.poses,
                                      self.ignore_mask)),
                          sharded=self.sharded)


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
                     device="cuda", mesh: Optional[Mesh] = None
                     ) -> TrainState:
    """Move ``model`` to ``device`` (after loading ``params``, a Flax param
    tree, when given: the ``--initmodel`` warm start) and build its
    optimizer.  With a ``mesh`` the device is the mesh's and the
    parameters are broadcast from rank 0."""
    device = training_device(mesh.device if mesh is not None else device)
    if params is not None:
        load_flax_params(model, params)
    model.to(device).train()
    if mesh is not None:
        replicate(model, mesh)
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


def _meshed(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the work (a 1x1 mesh does not)."""
    return mesh is not None and mesh.n_data * mesh.n_spatial > 1


def loss_for_batch(model: nn.Module, batch: TrainBatch, cfg: TrainConfig,
                   mesh: Optional[Mesh] = None):
    """(total, metrics) of ``model`` on ``batch`` (already on the model's
    device); on a ``mesh`` that splits the work, this rank's part of
    both (``batch`` is its part: ``shard_batch``)."""
    if _meshed(mesh):
        return _rank_loss(model, batch, cfg, mesh)
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


def _rank_loss(model: nn.Module, batch: TrainBatch, cfg: TrainConfig,
               mesh: Mesh):
    """This rank's part of the global loss: the forward on its slab with
    halos, the GT of its slab's output rows, the ignore mask resized on
    the whole image's rows (gathered over ``spatial``) and cut to the
    slab's, squared errors over the global element count.  The GT is
    rendered at the output resolution whatever ``cfg.gt_at_output_res``
    (the full render resized, up to summation order)."""
    x = preprocess_imgs(batch.imgs)
    slabs = (SpatialSlabs.gathered(mesh, x.shape[1], x.device)
             if mesh.n_spatial > 1 else None)

    def forward(x):
        if slabs is None:
            return model(x)
        with spatial_halos(model, slabs):
            return model(x)

    if cfg.remat and torch.is_grad_enabled():
        outs = checkpoint(forward, x, use_reentrant=False)
    else:
        outs = forward(x)
    two = isinstance(outs, tuple)
    rows, out_w = (outs[0] if two else outs).shape[2:4]
    mask = batch.ignore_mask
    if slabs is None:
        out_h, first = rows, 0
    else:
        out_h, first = sum(slabs.level_sizes(rows)), slabs.offset(rows)
        mask = slabs.gather(mask.to(torch.uint8), dim=1)
    h, w = mask.shape[1:3]
    out_rows = (first, first + rows)
    mask = prepare_mask(mask, (out_h, out_w))[:, first:first + rows]
    # the global B * h: the sum over every rank of B_d * rows_s
    positions = torch.tensor(float(batch.imgs.shape[0] * rows),
                             dtype=torch.float64, device=x.device)
    dist.all_reduce(positions)
    positions = int(positions.item()) * out_w
    with torch.no_grad():
        if two:
            pafs_t, heatmaps_t = render_labels_at(
                batch.poses, h, w, (out_h, out_w), cfg.heatmap_sigma,
                cfg.paf_sigma, out_rows=out_rows)
        else:
            heatmaps_t = render_heatmaps_at(
                batch.poses, h, w, (out_h, out_w), cfg.heatmap_sigma,
                out_rows=out_rows)
    if two:
        return compute_loss(outs[0], outs[1], _gt_nhwc(pafs_t),
                            _gt_nhwc(heatmaps_t), mask, positions)
    return compute_loss_single(outs, _gt_nhwc(heatmaps_t), mask, positions)


def _reduce_metrics(metrics, mesh: Mesh):
    """The global metrics from every rank's part: one ``all_reduce(SUM)``
    of the per-stage vectors (a world of one returns them as they are)."""
    if not mesh.distributed:
        return metrics
    paf, heat = metrics["paf_stages"], metrics["heat_stages"]
    flat = torch.cat([paf, heat])
    dist.all_reduce(flat)
    paf, heat = flat[:paf.numel()], flat[paf.numel():]
    total = paf.sum() + heat.sum()
    return {"loss": total, "paf": paf.sum(), "heat": heat.sum(),
            "paf_stages": paf, "heat_stages": heat}


def all_reduce_grads(model: nn.Module, mesh: Mesh) -> None:
    """Sum every gradient of ``model`` over the whole world in one flat
    ``all_reduce``."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _local(batch: TrainBatch, mesh: Optional[Mesh]) -> TrainBatch:
    """This rank's part of ``batch`` (a global batch, or one already
    sharded)."""
    if _meshed(mesh) and not batch.sharded:
        return shard_batch(batch, mesh)
    return batch


def make_train_step(cfg: TrainConfig = TRAIN, mesh: Optional[Mesh] = None):
    """``step(state, batch) -> (state, metrics)``: one optimizer step on
    ``batch`` (host or device tensors), ``state`` updated in place; the
    metrics are detached device scalars and per-stage vectors.

    With a ``mesh`` every rank calls the step with the same global batch
    (or its own part of it, ``sharded``) and gets the one-process step's
    parameters and metrics."""

    def step_fn(state: TrainState, batch: TrainBatch):
        batch = _local(batch, mesh).to(_device_of(state.model),
                                       non_blocking=True)
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_for_batch(state.model, batch, cfg, mesh)
        total.backward()
        if mesh is not None:
            all_reduce_grads(state.model, mesh)
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            metrics = _reduce_metrics(metrics, mesh)
        return state, metrics

    return step_fn


def make_eval_step(cfg: TrainConfig = TRAIN, mesh: Optional[Mesh] = None):
    """``eval_step(model, batch) -> metrics``: the validation loss; on a
    ``mesh`` the global one, on every rank."""

    @torch.no_grad()
    def eval_fn(model: nn.Module, batch: TrainBatch):
        batch = _local(batch, mesh).to(_device_of(model), non_blocking=True)
        _, metrics = loss_for_batch(model, batch, cfg, mesh)
        if mesh is not None:
            metrics = _reduce_metrics(metrics, mesh)
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
