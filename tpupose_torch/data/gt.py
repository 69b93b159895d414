"""Ground-truth rendering on the device: poses -> heatmaps and PAFs (port
of ``tpupose/data/gt.py``).

The same math as the JAX renderers, as dense fixed-shape broadcasts over a
padded pose table.  Where JAX ``vmap``s a per-sample renderer over the
batch, these functions broadcast over any leading axes of ``poses``:
``(P, K, 3)`` gives ``(K + 1, H, W)`` maps and ``(B, P, K, 3)`` gives
``(B, K + 1, H, W)``.

* heatmap per joint = max over persons of ``exp(-0.5 d^2 / sigma^2)``;
  the background channel is ``1 - max`` over all joints and persons.
* PAF per limb = its unit vector inside the rectangle of half-width
  ``paf_sigma`` around the segment, averaged where limbs of several persons
  overlap.  The count is the reference's nonzero-component count: a person
  limb adds ``x_nonzero | y_nonzero``, which equals its in-band flag
  because a unit vector never has both components zero.
* zero-length limbs contribute nothing; an empty table (P = 0) gives the
  all-background heatmaps and zero fields.

Pixel centres are at integer coordinates (``arange(W)``, ``arange(H)``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tpupose_torch.config import LIMBS, LIMBS_FROM, LIMBS_TO, NUM_JOINTS
from tpupose_torch.ops.resize import _linear_matrix_align_corners

# A grid is the pair (gx (1, W'), gy (H', 1)) of float32 pixel coordinates
# the analytic maps are evaluated at: the full integer pixel grid, or the
# sparse sub-grid of fine rows and columns that the align-corners bilinear
# downsample reads (``render_*_at``).
Grid = Tuple[torch.Tensor, torch.Tensor]


def _grids(height: int, width: int, device) -> Grid:
    gx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    gy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    return gx, gy


def render_heatmaps(poses: torch.Tensor, height: int, width: int,
                    sigma: float, grid: Optional[Grid] = None
                    ) -> torch.Tensor:
    """poses: (..., P, K, 3) float32 ``[x, y, v]`` rows (v > 0 = labeled)
    -> (..., K + 1, H, W) float32: K keypoint channels and the background.
    K is 18 for the pose net, 70 or 21 for the crop nets.  With ``grid``
    the maps are evaluated at its coordinates instead of the pixel grid."""
    gx, gy = grid if grid is not None else _grids(height, width,
                                                   poses.device)
    height, width = gy.shape[0], gx.shape[1]
    lead, k = poses.shape[:-3], poses.shape[-2]
    if poses.shape[-3] == 0:  # no people: all background
        return torch.cat([
            torch.zeros(*lead, k, height, width, device=poses.device),
            torch.ones(*lead, 1, height, width, device=poses.device)],
            dim=-3)
    x = poses[..., 0][..., None, None]          # (..., P, K, 1, 1)
    y = poses[..., 1][..., None, None]
    v = poses[..., 2][..., None, None] > 0
    d2 = (gx - x) ** 2 + (gy - y) ** 2
    g = torch.exp(-0.5 * d2 / (sigma * sigma))
    g = torch.where(v, g, 0.0)                  # (..., P, K, H, W)
    heatmaps = g.amax(dim=-4)                   # (..., K, H, W)
    bg = 1.0 - heatmaps.amax(dim=-3, keepdim=True)
    return torch.cat([heatmaps, bg], dim=-3)


def render_pafs(poses: torch.Tensor, height: int, width: int,
                paf_width: float, grid: Optional[Grid] = None
                ) -> torch.Tensor:
    """poses: (..., P, 18, 3) -> (..., 38, H, W) float32 part-affinity
    fields, limb i in channels 2i and 2i + 1.  With ``grid`` the fields are
    evaluated at its coordinates instead of the pixel grid."""
    gx, gy = grid if grid is not None else _grids(height, width,
                                                   poses.device)
    height, width = gy.shape[0], gx.shape[1]
    lead = poses.shape[:-3]
    if poses.shape[-3] == 0:  # no people: zero fields
        return torch.zeros(*lead, 2 * len(LIMBS), height, width,
                           device=poses.device)
    jf = poses[..., torch.from_numpy(LIMBS_FROM).long().to(poses.device), :]
    jt = poses[..., torch.from_numpy(LIMBS_TO).long().to(poses.device), :]
    valid = (jf[..., 2] > 0) & (jt[..., 2] > 0)  # (..., P, L)

    dx = jt[..., 0] - jf[..., 0]
    dy = jt[..., 1] - jf[..., 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    nonzero = dist > 0
    valid = valid & nonzero
    safe = torch.where(nonzero, dist, 1.0)
    ux, uy = dx / safe, dy / safe               # (..., P, L)
    # The perpendicular of the reference's rot(pi/2): (uy, -ux).
    px_, py_ = uy, -ux

    def e(t):  # (..., P, L) -> (..., P, L, 1, 1)
        return t[..., None, None]

    rx = gx - e(jf[..., 0])                     # (..., P, L, H, W)
    ry = gy - e(jf[..., 1])
    horiz = e(ux) * rx + e(uy) * ry
    vert = e(px_) * rx + e(py_) * ry
    flag = ((horiz >= 0.0) & (horiz <= e(dist))
            & (vert.abs() <= paf_width) & e(valid))

    count = flag.sum(dim=-4).float()            # (..., L, H, W)
    sum_x = torch.where(flag, e(ux), 0.0).sum(dim=-4)
    sum_y = torch.where(flag, e(uy), 0.0).sum(dim=-4)
    safe_count = torch.where(count > 0, count, 1.0)
    paf = torch.stack([sum_x / safe_count, sum_y / safe_count], dim=-3)
    return paf.reshape(*lead, 2 * len(LIMBS), height, width)


def render_labels(poses: torch.Tensor, height: int, width: int,
                  heatmap_sigma: float, paf_sigma: float):
    """(pafs, heatmaps), channels first, at the input resolution."""
    heatmaps = render_heatmaps(poses, height, width, heatmap_sigma)
    pafs = render_pafs(poses, height, width, paf_sigma)
    return pafs, heatmaps


# ---------------------------------------------------------------------------
# Rendering directly at the stage output resolution
# ---------------------------------------------------------------------------
#
# The align-corners bilinear downsample reads at most 2x2 integer points of
# the fine grid per output pixel, so evaluating the analytic maps at only
# the fine rows and columns it reads and applying its weights there is the
# resize of the full-resolution render, without the full-resolution maps.


@functools.lru_cache(maxsize=64)
def _output_res_grid(in_size: int, out_size: int):
    """(fine coordinates (N,), weights (out, N)): the align-corners bilinear
    matrix restricted to its nonzero columns."""
    m = _linear_matrix_align_corners(in_size, out_size)
    cols = np.nonzero(m.any(axis=0))[0]
    return cols.astype(np.float32), m[:, cols].copy()


def _subgrid_weights(height: int, width: int, out_hw: Tuple[int, int],
                     device):
    ys, wh = _output_res_grid(height, out_hw[0])
    xs, ww = _output_res_grid(width, out_hw[1])
    grid = (torch.from_numpy(xs).to(device)[None, :],
            torch.from_numpy(ys).to(device)[:, None])
    return grid, torch.from_numpy(wh).to(device), \
        torch.from_numpy(ww).to(device)


def _combine(maps: torch.Tensor, wh: torch.Tensor,
             ww: torch.Tensor) -> torch.Tensor:
    """(..., C, Ny, Nx) sub-grid maps -> (..., C, out_h, out_w) through the
    restricted bilinear weights (float32 matmuls: callers keep TF32 off)."""
    return wh @ maps @ ww.T


def render_heatmaps_at(poses: torch.Tensor, height: int, width: int,
                       out_hw: Tuple[int, int], sigma: float
                       ) -> torch.Tensor:
    """``resize_chainer`` of ``render_heatmaps`` to ``out_hw`` without the
    full-resolution maps (equal up to summation order, ~1e-7)."""
    grid, wh, ww = _subgrid_weights(height, width, out_hw, poses.device)
    return _combine(render_heatmaps(poses, height, width, sigma, grid=grid),
                    wh, ww)


def render_pafs_at(poses: torch.Tensor, height: int, width: int,
                   out_hw: Tuple[int, int], paf_width: float
                   ) -> torch.Tensor:
    """``resize_chainer`` of ``render_pafs`` to ``out_hw`` without the
    full-resolution fields (the overlap average is pointwise, so it
    commutes with evaluating at the sub-grid)."""
    grid, wh, ww = _subgrid_weights(height, width, out_hw, poses.device)
    return _combine(render_pafs(poses, height, width, paf_width, grid=grid),
                    wh, ww)


def render_labels_at(poses: torch.Tensor, height: int, width: int,
                     out_hw: Tuple[int, int], heatmap_sigma: float,
                     paf_sigma: float):
    """(pafs, heatmaps) rendered directly at the stage output
    resolution."""
    grid, wh, ww = _subgrid_weights(height, width, out_hw, poses.device)
    heatmaps = render_heatmaps(poses, height, width, heatmap_sigma,
                               grid=grid)
    pafs = render_pafs(poses, height, width, paf_sigma, grid=grid)
    return _combine(pafs, wh, ww), _combine(heatmaps, wh, ww)


# ---------------------------------------------------------------------------
# NumPy oracles (the reference's loops, dynamic shapes) for tests
# ---------------------------------------------------------------------------


def render_heatmaps_numpy(poses: np.ndarray, height: int, width: int,
                          sigma: float) -> np.ndarray:
    """The reference's per-joint, per-person loop."""
    heatmaps = np.zeros((NUM_JOINTS + 1, height, width), np.float32)
    sum_heatmap = np.zeros((height, width))
    gx = np.tile(np.arange(width), (height, 1))
    gy = np.tile(np.arange(height), (width, 1)).T
    for j in range(NUM_JOINTS):
        heatmap = np.zeros((height, width))
        for pose in poses:
            if pose[j, 2] > 0:
                d2 = (gx - pose[j, 0]) ** 2 + (gy - pose[j, 1]) ** 2
                jm = np.exp(-0.5 * d2 / sigma**2)
                heatmap = np.maximum(heatmap, jm)
                sum_heatmap = np.maximum(sum_heatmap, jm)
        heatmaps[j] = heatmap
    heatmaps[-1] = 1.0 - sum_heatmap
    return heatmaps


def render_pafs_numpy(poses: np.ndarray, height: int, width: int,
                      paf_width: float) -> np.ndarray:
    """The reference's per-limb, per-person loop."""
    gx = np.tile(np.arange(width), (height, 1))
    gy = np.tile(np.arange(height), (width, 1)).T
    pafs = np.zeros((0, height, width))
    for (a, b) in LIMBS:
        paf = np.zeros((2, height, width))
        flags = np.zeros(paf.shape)
        for pose in poses:
            jf, jt = pose[a], pose[b]
            if jf[2] > 0 and jt[2] > 0:
                if np.array_equal(jf[:2], jt[:2]):
                    continue
                dist = np.linalg.norm(jt[:2].astype(float) - jf[:2])
                u = (jt[:2].astype(float) - jf[:2]) / dist
                vp = np.array([u[1], -u[0]])
                horiz = u[0] * (gx - jf[0]) + u[1] * (gy - jf[1])
                vert = vp[0] * (gx - jf[0]) + vp[1] * (gy - jf[1])
                flag = (horiz >= 0) & (horiz <= dist) & (np.abs(vert)
                                                         <= paf_width)
                limb_paf = np.stack([flag, flag]) * u[:, None, None]
                limb_flags = limb_paf != 0
                flags += np.broadcast_to(limb_flags[0] | limb_flags[1],
                                         limb_paf.shape)
                paf += limb_paf
        paf[flags > 0] /= flags[flags > 0]
        pafs = np.vstack((pafs, paf))
    return pafs.astype(np.float32)
