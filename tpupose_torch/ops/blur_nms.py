"""Fused Gaussian blur + 4-neighbour peak NMS: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``tpupose/ops/pallas/blur_nms.py::
blur_nms_pallas``.  ``blur_nms`` routes by the device of its input only: a
CPU tensor takes ``blur_nms_reference``; a CUDA tensor launches the kernel in
``tpupose_torch/csrc/blur_nms.cu`` or raises.  There is no fallback.

The kernel is built with ``nvcc`` for ``sm_90a`` at its first launch, into
``tpupose_torch/_build/`` under a name keyed by a hash of the source and the
flags, and loaded with ``ctypes`` (a plain C entry point, no PyTorch
headers, so the build takes seconds).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

import torch

from tpupose_torch.ops.gaussian import (gaussian_blur_reflect,
                                        scipy_gaussian_kernel_1d)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "blur_nms.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Must equal BLUR_NMS_MAX_RADIUS in csrc/blur_nms.cu.
MAX_RADIUS = 16


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
    run the kernel, which adds one to ``blur_nms.launches`` per launch."""
    if heatmaps.device.type == "cpu":
        return blur_nms_reference(heatmaps, sigma, thresh)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"blur_nms: unsupported device {heatmaps.device}")
    if heatmaps.dtype != torch.float32 or heatmaps.dim() != 3:
        raise ValueError(f"blur_nms: expected (J, H, W) float32, got "
                         f"{heatmaps.dtype} {tuple(heatmaps.shape)}")
    if not heatmaps.is_contiguous():
        raise ValueError("blur_nms: input must be contiguous")
    taps = scipy_gaussian_kernel_1d(sigma)
    radius = (len(taps) - 1) // 2
    if radius > MAX_RADIUS:
        raise ValueError(f"blur_nms: sigma {sigma} needs radius {radius} > "
                         f"{MAX_RADIUS}")
    j, h, w = heatmaps.shape
    smoothed = torch.empty_like(heatmaps)
    mask = torch.empty(heatmaps.shape, dtype=torch.bool,
                       device=heatmaps.device)
    lib = _library()
    c_taps = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blur_nms_launch(
            heatmaps.data_ptr(), smoothed.data_ptr(), mask.data_ptr(),
            j, h, w, c_taps, radius, float(thresh), stream)
    if err != 0:
        raise RuntimeError(f"blur_nms kernel launch failed: CUDA error {err} "
                           f"({lib.blur_nms_error_string(err).decode()})")
    blur_nms.launches += 1
    return smoothed, mask


blur_nms.launches = 0


def build() -> str:
    """Compile ``csrc/blur_nms.cu`` unless the hashed library exists;
    returns its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"blur_nms-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE], check=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_nms_launch.argtypes = [p, p, p, i, i, i,
                                    ctypes.POINTER(ctypes.c_float), i,
                                    ctypes.c_float, p]
    lib.blur_nms_launch.restype = i
    lib.blur_nms_error_string.argtypes = [i]
    lib.blur_nms_error_string.restype = ctypes.c_char_p
    return lib
