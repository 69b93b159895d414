"""Gaussian heatmap smoothing (port of ``tpupose/ops/gaussian.py``).

Scipy mode: SciPy's ``gaussian_filter`` with ``truncate=4`` and *reflect*
boundary: the edge pixel is mirrored including itself, numpy's
``"symmetric"`` pad.  ``F.pad`` has no such mode (its ``"reflect"`` is
numpy's ``reflect``), so the padded index is built on the host with
``np.pad`` and gathered; that also covers maps smaller than the radius,
where the reflection repeats.

Conv mode (``nms_mode="conv"``): the reference's GPU branch, an
unnormalised ``ksize`` Gaussian with zero padding.  Both run the same
separable shift-and-add, taps in the same order.
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

    heatmaps: (..., H, W) -> float32 of the same shape, through
    ``_separable_blur``.
    """
    taps = [float(t) for t in scipy_gaussian_kernel_1d(sigma, truncate)]
    r = (len(taps) - 1) // 2
    dev = heatmaps.device

    def pad(x, dim):
        index = symmetric_index(x.shape[dim], r)
        return x.index_select(dim, torch.from_numpy(index).to(dev))

    return _separable_blur(heatmaps.float(), taps, pad)


@functools.lru_cache(maxsize=32)
def conv_gaussian_kernel_1d(sigma: float, ksize: int) -> np.ndarray:
    """1-D factor of the reference GPU path's 2-D kernel: the unnormalised
    density ``exp(-d^2 / (2 sigma^2)) / sqrt(2 pi sigma^2)`` at offsets
    ``d = k - ksize // 2``, so an even ``ksize`` centres at
    ``int(ksize / 2)``.  The 2-D kernel is its outer product."""
    if ksize < 1:
        raise ValueError(f"conv NMS smoothing needs ksize >= 1, got "
                         f"{ksize} (InferenceConfig.ksize)")
    center = ksize // 2
    d = np.arange(ksize, dtype=np.float64) - center
    phi = np.exp(-0.5 * (d / sigma) ** 2) / np.sqrt(2.0 * np.pi * sigma ** 2)
    return phi.astype(np.float32)


def gaussian_blur_conv_zero(heatmaps: torch.Tensor, sigma: float,
                            ksize: int) -> torch.Tensor:
    """Zero-padded ``ksize`` Gaussian (the conv NMS mode's smoothing).

    heatmaps: (..., H, W) -> float32 of the same shape; output ``i`` sums
    ``x[i + k - ksize // 2] * taps[k]`` with zeros outside the map.  As in
    ``gaussian_blur_reflect``, symmetric taps on equal inputs give
    bit-equal outputs, which keeps the plateau ties the ``>=`` rule
    reads."""
    taps = [float(t) for t in conv_gaussian_kernel_1d(sigma, ksize)]
    center = ksize // 2
    pads = (center, ksize - 1 - center)

    def pad(x, dim):
        if dim == -2:
            return torch.nn.functional.pad(x, (0, 0, *pads))
        return torch.nn.functional.pad(x, pads)

    return _separable_blur(heatmaps.float(), taps, pad)


def _separable_blur(x: torch.Tensor, taps, pad) -> torch.Tensor:
    """Rows first, then columns; each pass accumulates ``x0*w0``, then
    ``acc + xk*wk`` in tap order, every product and sum rounded to float32
    on its own (the CUDA kernel in ``blur_nms`` repeats this order bit for
    bit).  ``pad(x, dim)`` extends axis ``dim`` by ``len(taps) - 1``."""
    h, w = x.shape[-2:]
    xp = pad(x, -2)
    acc = xp[..., 0:h, :] * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xp[..., k:k + h, :] * taps[k]
    yp = pad(acc, -1)
    out = yp[..., 0:w] * taps[0]
    for k in range(1, len(taps)):
        out = out + yp[..., k:k + w] * taps[k]
    return out
