"""Resizes of the reference, frozen from ``tpupose_torch/ops/resize.py``.

``resize_u8_linear`` restates cv2's fixed-point uint8 INTER_LINEAR in numpy
(11-bit coefficients, an exact integer horizontal pass, the SIMD vertical
pass's descale).  ``resize_align_corners`` is Chainer's ``resize_images``
(align-corners bilinear) as two float32 matmuls with dense weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_COEF_SCALE = np.float32(2048)


def _cv2_linear_taps(in_size: int, out_size: int, clamp: bool):
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    src = np.floor(f).astype(np.int64)
    f = (f - src.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (src < 0) | (src >= in_size - 1)
        f[edge] = 0.0
        src = np.clip(src, 0, in_size - 1)
    c0 = np.rint((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int32)
    c1 = np.rint(f * _COEF_SCALE).astype(np.int32)
    return src, c0, c1


def resize_u8_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a uint8 HWC image; ``size`` is
    ``(width, height)``."""
    w, h = size
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (h, w):
        return img.copy()
    x = img.reshape(in_h, in_w, -1)
    sx, a0, a1 = _cv2_linear_taps(in_w, w, clamp=True)
    sy, b0, b1 = _cv2_linear_taps(in_h, h, clamp=False)
    sx1 = np.minimum(sx + 1, in_w - 1)
    rows = (x[:, sx].astype(np.int32) * a0[None, :, None]
            + x[:, sx1].astype(np.int32) * a1[None, :, None]) >> 4
    s0 = rows[np.clip(sy, 0, in_h - 1)]
    s1 = rows[np.clip(sy + 1, 0, in_h - 1)]
    out = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (h, w) + img.shape[2:])


@functools.lru_cache(maxsize=512)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = src - i0
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, i1), frac.astype(np.float32))
    return m


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """(..., H, W, C) float32 -> (..., out_h, out_w, C), align-corners
    bilinear; run it with float32 matmuls at full precision."""
    in_h, in_w, c = x.shape[-3:]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(_align_corners_matrix(in_h, out_h)).to(x.device)
    mw = torch.from_numpy(_align_corners_matrix(in_w, out_w)).to(x.device)
    lead = x.shape[:-3]
    y = torch.matmul(mh, x.reshape(*lead, in_h, in_w * c))
    return torch.matmul(mw, y.reshape(*lead, out_h, in_w, c))


def optimal_size(img_h: int, img_w: int, target: int, stride: int = 8):
    """(width, height): the short side ``target``, the long side rounded
    half-to-even and up to a multiple of ``stride``."""
    aspect = img_h / img_w
    if img_h < img_w:
        out_h, out_w = target, int(np.round(target / aspect))
        out_w += (-out_w) % stride
    else:
        out_w, out_h = target, int(np.round(target * aspect))
        out_h += (-out_h) % stride
    return out_w, out_h
