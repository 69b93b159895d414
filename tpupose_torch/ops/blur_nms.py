"""Fused Gaussian blur + 4-neighbour peak NMS: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``tpupose/ops/pallas/blur_nms.py::
blur_nms_pallas``.  ``blur_nms`` routes by the device of its input only: a
CPU tensor takes ``blur_nms_reference``; a CUDA tensor launches the kernel in
``tpupose_torch/csrc/blur_nms.cu`` or raises.  There is no fallback.

The kernel is built at its first launch by ``ops/_cuda_build.py``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.gaussian import (gaussian_blur_reflect,
                                        scipy_gaussian_kernel_1d)

# Must equal BLUR_NMS_MAX_TAPS_RADIUS in csrc/blur_nms.cu, the size of the
# taps array a launch carries (sigma ~63.6 at truncate 4).  Radii 0-16 take
# the kernel unrolled per radius, larger ones its run-time-tap kernel.
MAX_RADIUS = 255


def nms_mask(smoothed: torch.Tensor, thresh: float) -> torch.Tensor:
    """4-neighbour strict local-max mask with zero borders.

    smoothed: (..., H, W) -> bool mask of the same shape: ``> thresh`` and
    ``>`` each neighbour, where neighbours outside the map count as 0."""
    h = smoothed
    pad = torch.nn.functional.pad
    up = pad(h[..., :-1, :], (0, 0, 1, 0))
    down = pad(h[..., 1:, :], (0, 0, 0, 1))
    left = pad(h[..., :, :-1], (1, 0))
    right = pad(h[..., :, 1:], (0, 1))
    return ((h > thresh) & (h > up) & (h > down) & (h > left)
            & (h > right))


def blur_nms_reference(heatmaps: torch.Tensor, sigma: float, thresh: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``gaussian_blur_reflect`` + ``nms_mask``.

    heatmaps: (J, H, W) -> (smoothed (J, H, W) float32, mask (J, H, W)
    bool)."""
    smoothed = gaussian_blur_reflect(heatmaps, sigma)
    return smoothed, nms_mask(smoothed, thresh)


def blur_nms(heatmaps: torch.Tensor, sigma: float, thresh: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J, H, W) float32 -> (smoothed float32, mask bool), the semantics of
    ``blur_nms_reference``.  CPU tensors run the plain version; CUDA tensors
    run the kernel at any radius up to ``MAX_RADIUS``, which adds one to
    ``blur_nms.launches`` per launch and to ``blur_nms.shapes[(J, H, W)]``."""
    if heatmaps.device.type == "cpu":
        return blur_nms_reference(heatmaps, sigma, thresh)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"blur_nms: unsupported device {heatmaps.device}")
    if heatmaps.dtype != torch.float32 or heatmaps.dim() != 3:
        raise ValueError(f"blur_nms: expected (J, H, W) float32, got "
                         f"{heatmaps.dtype} {tuple(heatmaps.shape)}")
    if not heatmaps.is_contiguous():
        raise ValueError("blur_nms: input must be contiguous")
    c_taps, radius = _taps(float(sigma))
    if radius > MAX_RADIUS:
        raise ValueError(f"blur_nms: sigma {sigma} needs radius {radius}; "
                         f"the kernel's taps array holds radii up to "
                         f"{MAX_RADIUS}")
    j, h, w = heatmaps.shape
    smoothed = torch.empty_like(heatmaps)
    mask = torch.empty(heatmaps.shape, dtype=torch.bool,
                       device=heatmaps.device)
    lib = _library()
    index = heatmaps.device.index
    args = (heatmaps.data_ptr(), smoothed.data_ptr(), mask.data_ptr(), j, h,
            w, c_taps, radius, float(thresh))
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        err = lib.blur_nms_launch(*args, stream)
    else:
        with torch.cuda.device(index):
            err = lib.blur_nms_launch(*args, stream)
    _cuda_build.check(lib, "blur_nms", err)
    blur_nms.launches += 1
    blur_nms.shapes[(j, h, w)] += 1
    return smoothed, mask


blur_nms.launches = 0
blur_nms.shapes = collections.Counter()


@functools.lru_cache(maxsize=8)
def _taps(sigma: float) -> Tuple[ctypes.Array, int]:
    """The kernel's taps for ``sigma`` as a ctypes float array, and the
    radius; built once per sigma (the launch copies them)."""
    taps = scipy_gaussian_kernel_1d(sigma)
    return (ctypes.c_float * len(taps))(*[float(t) for t in taps]), \
        (len(taps) - 1) // 2


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("blur_nms")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_nms_launch.argtypes = [p, p, p, i, i, i,
                                    ctypes.POINTER(ctypes.c_float), i,
                                    ctypes.c_float, p]
    lib.blur_nms_launch.restype = i
    return lib
