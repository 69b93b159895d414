"""Gaussian heatmap smoothing with SciPy-parity semantics (port of
``tpupose/ops/gaussian.py``, scipy mode).

SciPy's ``gaussian_filter`` with ``truncate=4`` and *reflect* boundary: the
edge pixel is mirrored including itself, numpy's ``"symmetric"`` pad.
``F.pad`` has no such mode (its ``"reflect"`` is numpy's ``reflect``), so the
padded index is built on the host with ``np.pad`` and gathered; that also
covers maps smaller than the radius, where the reflection repeats.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def scipy_gaussian_kernel_1d(sigma: float, truncate: float = 4.0
                             ) -> np.ndarray:
    """1-D kernel identical to scipy.ndimage._gaussian_kernel1d (normalized)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    return phi.astype(np.float32)


@functools.lru_cache(maxsize=64)
def symmetric_index(n: int, radius: int) -> np.ndarray:
    """Source index of each position of an n-long axis padded by ``radius``
    on both sides in numpy's ``"symmetric"`` mode."""
    return np.pad(np.arange(n), radius, mode="symmetric")


def gaussian_blur_reflect(heatmaps: torch.Tensor, sigma: float,
                          truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur with SciPy 'reflect' boundary.

    heatmaps: (..., H, W) -> float32 of the same shape.  Rows are blurred
    first, then columns; each pass accumulates ``x0*w0``, then
    ``acc + xk*wk`` in tap order, with every product and sum rounded to
    float32 on its own (the CUDA kernel in ``blur_nms`` repeats this order
    bit for bit).
    """
    taps = [float(t) for t in scipy_gaussian_kernel_1d(sigma, truncate)]
    r = (len(taps) - 1) // 2
    h, w = heatmaps.shape[-2:]
    x = heatmaps.float()
    dev = x.device
    xp = x.index_select(-2, torch.from_numpy(symmetric_index(h, r)).to(dev))
    acc = xp[..., 0:h, :] * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xp[..., k:k + h, :] * taps[k]
    yp = acc.index_select(-1, torch.from_numpy(symmetric_index(w, r)).to(dev))
    out = yp[..., 0:w] * taps[0]
    for k in range(1, len(taps)):
        out = out + yp[..., k:k + w] * taps[k]
    return out
