"""Resizes as dense interpolation matmuls, plus numpy emulations of cv2's
uint8 bilinear and bicubic resizes (port of ``tpupose/ops/resize.py``).

The three matrix builders and ``compute_optimal_size`` are copies of the JAX
module's numpy code (that module imports ``jax.numpy``, which this package
must not).  ``resize_hw`` runs ``out = M_h @ x @ M_w^T`` as two float32
``torch.matmul`` calls; callers pin the matmul precision to ``"highest"``
(TF32 would cost ~1e-3 and move integer peak coordinates).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) bilinear weights, align-corners (Chainer resize_images)."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1:
        # src = 0 under align-corners scaling.
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = (src - i0).astype(np.float64)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, i1), frac.astype(np.float32))
    return m


@functools.lru_cache(maxsize=256)
def _linear_matrix_half_pixel(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) bilinear weights, half-pixel centers (cv2 INTER_LINEAR)."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i0c = np.clip(i0, 0, in_size - 1)
    i1c = np.clip(i0 + 1, 0, in_size - 1)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0c), (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, i1c), frac.astype(np.float32))
    return m


def _keys_cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (cv2's INTER_CUBIC uses a = -0.75)."""
    t = np.abs(t)
    w = np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a,
                 0.0),
    )
    return w


@functools.lru_cache(maxsize=256)
def _cubic_matrix_half_pixel(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) 4-tap cubic weights, half-pixel centers + edge clamp."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    rows = np.arange(out_size)
    for tap in (-1, 0, 1, 2):
        w = _keys_cubic_weight(frac - tap)
        idx = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(m, (rows, idx), w.astype(np.float32))
    return m


_MATRIX_BUILDERS = {
    "linear_align_corners": _linear_matrix_align_corners,
    "linear_half_pixel": _linear_matrix_half_pixel,
    "cubic_half_pixel": _cubic_matrix_half_pixel,
}


def resize_hw(x: torch.Tensor, out_hw: Tuple[int, int],
              method: str = "linear_half_pixel") -> torch.Tensor:
    """Resize the (-3, -2) spatial axes of a channels-last tensor.

    x: (..., H, W, C) float32 -> (..., out_h, out_w, C).  ``method`` is one
    of ``linear_align_corners`` (Chainer F.resize_images),
    ``linear_half_pixel`` (cv2 INTER_LINEAR), ``cubic_half_pixel``
    (cv2 INTER_CUBIC).
    """
    builder = _MATRIX_BUILDERS[method]
    in_h, in_w, c = x.shape[-3], x.shape[-2], x.shape[-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(builder(in_h, out_h)).to(x.device)
    mw = torch.from_numpy(builder(in_w, out_w)).to(x.device)
    lead = x.shape[:-3]
    y = torch.matmul(mh, x.reshape(*lead, in_h, in_w * c))
    y = torch.matmul(mw, y.reshape(*lead, out_h, in_w, c))
    return y


def resize_chainer(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Chainer ``F.resize_images`` parity (align-corners bilinear)."""
    return resize_hw(x, out_hw, "linear_align_corners")


def resize_cv2_cubic(x: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """cv2 ``INTER_CUBIC`` parity (half-pixel Keys cubic, a=-0.75)."""
    return resize_hw(x, out_hw, "cubic_half_pixel")


def compute_optimal_size(img_h: int, img_w: int, target: int,
                         stride: int = 8) -> Tuple[int, int]:
    """Scale so the *short* side ~= target, long side rounded up to a stride
    multiple; returns (width, height), with ``np.round`` half-to-even."""
    aspect = img_h / img_w
    if img_h < img_w:
        out_h = target
        out_w = int(np.round(target / aspect))
        if out_w % stride != 0:
            out_w += stride - out_w % stride
    else:
        out_w = target
        out_h = int(np.round(target * aspect))
        if out_h % stride != 0:
            out_h += stride - out_h % stride
    return out_w, out_h


# cv2's fixed-point bilinear coefficients: INTER_RESIZE_COEF_BITS = 11.
_COEF_SCALE = np.float32(2048)


def _cv2_linear_taps(in_size: int, out_size: int, clamp: bool):
    """Per-output source index and the two 11-bit coefficients, computed in
    float32 as cv2's ``resizeGeneric`` does.  Columns clamp the source at
    both borders (``clamp``); rows keep the raw index and clamp the rows
    they read instead."""
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
    """``cv2.resize(img, (w, h))`` for uint8 HW or HWC images, in numpy.

    Emulates cv2's fixed-point INTER_LINEAR: 11-bit coefficients, an exact
    integer horizontal pass, and the vertical pass with the descale of its
    SIMD path, ``((S0>>4)*b0>>16) + ((S1>>4)*b1>>16) + 2 >> 2``.  ``size``
    is ``(width, height)`` as cv2 takes it.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 HW or HWC image, got "
                         f"{img.dtype} {img.shape}")
    w, h = size
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (h, w):
        return img.copy()
    x = img.reshape(in_h, in_w, -1)
    sx, a0, a1 = _cv2_linear_taps(in_w, w, clamp=True)
    sy, b0, b1 = _cv2_linear_taps(in_h, h, clamp=False)
    sx1 = np.minimum(sx + 1, in_w - 1)
    # int32 is exact: 255 * 2048 fits, and so does (S >> 4) * 2048.
    rows = (x[:, sx].astype(np.int32) * a0[None, :, None]
            + x[:, sx1].astype(np.int32) * a1[None, :, None]) >> 4
    s0 = rows[np.clip(sy, 0, in_h - 1)]
    s1 = rows[np.clip(sy + 1, 0, in_h - 1)]
    out = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (h, w) + img.shape[2:])


def _cv2_cubic_taps(in_size: int, out_size: int):
    """Per-output source indices (4 taps, clamped to the axis) and 11-bit
    coefficients of cv2's INTER_CUBIC: ``interpolateCubic``'s Keys weights
    (A = -0.75) in float32 at the float32 fraction, scaled by 2048 and
    rounded to short."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    src = np.floor(f).astype(np.int64)
    x = (f - src.astype(np.float32)).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1.0)
    x1 = x + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)
    coef = np.clip(np.rint(coef * _COEF_SCALE), -32768, 32767).astype(
        np.int64)
    idx = np.clip(src[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    return idx, coef


# cv2's vertical cubic pass runs 8 outputs at a time through float32 (two
# 4-lane SSE vectors); the row's remaining outputs take the integer path.
_CUBIC_VECTOR = 8


def resize_u8_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` for uint8
    HW or HWC images, in numpy: OpenCV's own algorithm (its generic
    ``resizeGeneric`` path, which ``cv2.ipp.setUseIPP(False)`` selects).

    Source indices clamp at both borders of both axes; the horizontal pass
    is exact integer arithmetic on 11-bit coefficients; the vertical pass
    is cv2's SIMD one: per output, ``S3*b3``, then ``S2*b2 + acc``,
    ``S1*b1 + acc``, ``S0*b0 + acc`` in float32 with ``b = beta / 2048^2``,
    rounded to nearest even and saturated, for the first multiple of 8 of
    each row's ``w * channels`` values, and ``(sum S*beta + 2^21) >> 22``
    for the rest.  ``size`` is ``(width, height)``.

    cv2 builds that ship Intel's IPP as a HAL (5.0's wheels) run
    INTER_CUBIC through IPP's float resize by default instead, which
    rounds ~5% of the values one level the other way.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 HW or HWC image, got "
                         f"{img.dtype} {img.shape}")
    w, h = size
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (h, w):
        return img.copy()
    x = img.reshape(in_h, in_w, -1).astype(np.int64)
    cn = x.shape[2]
    ix, alpha = _cv2_cubic_taps(in_w, w)
    iy, beta = _cv2_cubic_taps(in_h, h)
    rows = (x[:, ix] * alpha[None, :, :, None]).sum(axis=2)  # (in_h, w, cn)
    s = rows[iy].reshape(h, 4, w * cn)                       # taps' rows
    # integer path
    out = ((s * beta[:, :, None]).sum(axis=1) + (1 << 21)) >> 22
    # float path, over the vectorised prefix of each row
    n_vec = (w * cn) // _CUBIC_VECTOR * _CUBIC_VECTOR
    if n_vec:
        b = beta.astype(np.float32) * np.float32(1.0 / (2048 * 2048))
        sf = s[:, :, :n_vec].astype(np.float32)
        acc = sf[:, 3] * b[:, 3, None]
        for k in (2, 1, 0):
            acc = sf[:, k] * b[:, k, None] + acc
        out[:, :n_vec] = np.rint(acc).astype(np.int64)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (h, w) + img.shape[2:])
