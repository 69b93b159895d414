"""The crop nets' keypoint tail, every crop of a request at once: the CUDA
kernel's wrapper and its plain PyTorch version.

Per crop ``i`` and keypoint channel ``c < C - 1`` of the last stage's
(B, h, w, C) float32 maps (channels last): resize (align corners, H then
W) to the crop's target ``(th, tw)``, mirror the resized map along W where
the crop was mirrored, blur (SciPy reflect Gaussian of ``sigma``) and take
the first maximum in row-major order.  The result is (B, 4, C - 1)
float32 rows of x, y, the blurred score there and ``score > thresh``: what
``CropKeypointDetector.tail_maps`` followed by ``global_argmax_keypoints``
gives crop by crop.

It replaces no TPU kernel: the JAX package runs this tail as plain XLA.
``crop_tails`` routes by the device of its input only: a CPU tensor takes
``crop_tails_plain``; a CUDA tensor launches
``tpupose_torch/csrc/crop_tail.cu`` (built at its first launch by
``ops/_cuda_build.py``) or raises.  There is no fallback.

Rounding.  Each resized value is ``fma(w_hi, x_hi, w_lo * x_lo)`` over the
two taps of its row of ``_linear_matrix_align_corners``: the K-sequential
FMA of a float32 matrix product, which reproduces the CPU's
``resize_chainer`` (a dense matmul) bit for bit.  PyTorch has no fused
multiply-add, so the plain version computes it in float64, where the
product is exact, and rounds the sum to odd before the float32 rounding
(``_fma``).  The blur and the argmax are ``global_argmax_keypoints``'s
own.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.gaussian import scipy_gaussian_kernel_1d
from tpupose_torch.ops.resize import _linear_matrix_align_corners

# Must equal CROP_TAIL_MAX_ITEMS, CROP_TAIL_MAX_SIDE, CROP_TAIL_MAX_RADIUS
# and CROP_TAIL_MAX_PLANE in csrc/crop_tail.cu: the crops one launch
# carries in its parameters, the longest target side, the blur's largest
# radius (sigma ~11.9) and the largest h x w source plane, which a block
# stages in shared memory: at both, a block takes 218,500 of the 232,448
# bytes of shared memory it may have.
MAX_ITEMS = 64
MAX_SIDE = 2048
MAX_RADIUS = 48
MAX_PLANE = 16384


@functools.lru_cache(maxsize=512)
def align_corners_taps(in_size: int, out_size: int):
    """Per output, the two taps of its row of
    ``_linear_matrix_align_corners(in_size, out_size)``: the first and the
    last nonzero column and their float32 weights (the second weight 0
    where the row has one nonzero)."""
    m = _linear_matrix_align_corners(in_size, out_size)
    nonzero = m != 0
    lo = np.argmax(nonzero, axis=1)
    hi = in_size - 1 - np.argmax(nonzero[:, ::-1], axis=1)
    rows = np.arange(out_size)
    w_lo = m[rows, lo]
    w_hi = np.where(hi > lo, m[rows, hi], np.float32(0))
    return lo, hi, w_lo, w_hi.astype(np.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.  The product of two float32 is
    exact in float64; the float64 sum is made round-to-odd (its error, from
    TwoSum, sets the last bit), and a round-to-odd value 29 bits finer
    than float32 rounds to float32 as the exact sum does."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Align-corners resize of ``x``'s axis ``dim`` to ``out_size``."""
    lo, hi, w_lo, w_hi = (torch.from_numpy(t).to(x.device)
                          for t in align_corners_taps(x.shape[dim],
                                                      out_size))
    shape = [1] * x.dim()
    shape[dim] = out_size
    w_lo, w_hi = w_lo.view(shape), w_hi.view(shape)
    return _fma(w_hi, x.index_select(dim, hi),
                x.index_select(dim, lo) * w_lo)


def crop_tails_plain(maps: torch.Tensor, targets: Sequence[Tuple[int, int]],
                     flips: Sequence[bool], sigma: float,
                     thresh: float) -> torch.Tensor:
    """The plain PyTorch version of ``crop_tails``, on any device, crop by
    crop, in the kernel's order: resize along H, then W (``_fma``), mirror,
    drop the background channel, ``global_argmax_keypoints``."""
    # ops.peaks imports ops.library, which imports this module
    from tpupose_torch.ops.peaks import global_argmax_keypoints

    rows = []
    for hm, (th, tw), flip in zip(maps, targets, flips, strict=True):
        resized = _resize_axis(_resize_axis(hm, th, 0), tw, 1)
        if flip:
            resized = torch.flip(resized, dims=(1,))
        x, y, score, valid = global_argmax_keypoints(
            resized.permute(2, 0, 1)[:-1], sigma, thresh)
        rows.append(torch.stack([x.float(), y.float(), score,
                                 valid.float()]))
    if not rows:
        return maps.new_empty((0, 4, maps.shape[-1] - 1))
    return torch.stack(rows)


def _check(maps, targets, flips, radius):
    if not isinstance(maps, torch.Tensor) or maps.dtype != torch.float32 \
            or maps.dim() != 4:
        raise ValueError(f"crop_tails: expected (B, h, w, C) float32 maps, "
                         f"got {getattr(maps, 'dtype', maps)} "
                         f"{tuple(getattr(maps, 'shape', ()))}")
    if not maps.is_contiguous():
        raise ValueError("crop_tails: maps must be contiguous")
    b, h, w, c = maps.shape
    if c < 2 or h * w > MAX_PLANE or h < 1 or w < 1:
        raise ValueError(f"crop_tails: maps {tuple(maps.shape)}; the kernel "
                         f"takes C >= 2 (a background channel) and h x w up "
                         f"to {MAX_PLANE}")
    if len(targets) != b or len(flips) != b:
        raise ValueError(f"crop_tails: {len(targets)} targets and "
                         f"{len(flips)} flips for {b} crops")
    for th, tw in targets:
        if not (1 <= th <= MAX_SIDE and 1 <= tw <= MAX_SIDE):
            raise ValueError(f"crop_tails: target size {(th, tw)}; the "
                             f"kernel takes sides 1 to {MAX_SIDE}")
    if radius > MAX_RADIUS:
        raise ValueError(f"crop_tails: the blur's radius {radius} is above "
                         f"the kernel's {MAX_RADIUS}")


def crop_tails(maps: torch.Tensor, targets: Sequence[Tuple[int, int]],
               flips: Sequence[bool], sigma: float,
               thresh: float) -> torch.Tensor:
    """Every crop's keypoint rows from its last-stage maps.

    maps: (B, h, w, C) float32, contiguous; targets: ``(th, tw)`` per crop;
    flips: whether each crop was mirrored.  Returns (B, 4, C - 1) float32
    rows of x, y, score and valid on ``maps``'s device.  CPU tensors run
    ``crop_tails_plain``; CUDA tensors run the kernel, ``MAX_ITEMS`` crops
    a launch, which adds one to ``crop_tails.launches`` per launch and to
    ``crop_tails.shapes[(h, w, C, ((th, tw, flip), ...))]`` for the
    launch's crops."""
    targets = [(int(th), int(tw)) for th, tw in targets]
    flips = [bool(f) for f in flips]
    c_taps, radius = _taps(float(sigma))
    _check(maps, targets, flips, radius)
    dev = maps.device
    if dev.type == "cpu":
        return crop_tails_plain(maps, targets, flips, sigma, thresh)
    if dev.type != "cuda":
        raise ValueError(f"crop_tails: unsupported device {dev}")
    b, h, w, c = maps.shape
    out = torch.empty((b, 4, c - 1), dtype=torch.float32, device=dev)
    items = [(th, tw, f) for (th, tw), f in zip(targets, flips)]
    with torch.cuda.device(dev):
        crop_tails.launches += _launch(
            _library(), maps, items, out, c_taps, radius, thresh,
            torch.cuda.current_stream().cuda_stream)
    for i in range(0, b, MAX_ITEMS):
        crop_tails.shapes[(h, w, c, tuple(items[i:i + MAX_ITEMS]))] += 1
    return out


crop_tails.launches = 0
crop_tails.shapes = collections.Counter()


def _launch(lib, maps, items, out, c_taps, radius, thresh, stream) -> int:
    """Launch on ``lib`` (the built library; the tests pass a host build of
    the same source), on ``stream``, ``MAX_ITEMS`` crops a launch, into
    ``out``; returns the number of launches."""
    _, h, w, c = maps.shape
    map_bytes = h * w * c * 4
    row_bytes = 4 * (c - 1) * 4
    launches = 0
    for i in range(0, len(items), MAX_ITEMS):
        chunk = items[i:i + MAX_ITEMS]
        c_items = (ctypes.c_int * (3 * len(chunk)))(
            *[int(v) for item in chunk for v in item])
        err = lib.crop_tail_launch(
            maps.data_ptr() + i * map_bytes, out.data_ptr() + i * row_bytes,
            c_items, len(chunk), h, w, c, c_taps, radius, float(thresh),
            stream)
        _cuda_build.check(lib, "crop_tail", err)
        launches += 1
    return launches


@functools.lru_cache(maxsize=8)
def _taps(sigma: float) -> Tuple[ctypes.Array, int]:
    """The blur's taps for ``sigma`` as a ctypes float array, and the
    radius; built once per sigma (the launch copies them)."""
    taps = scipy_gaussian_kernel_1d(sigma)
    return (ctypes.c_float * len(taps))(*[float(t) for t in taps]), \
        (len(taps) - 1) // 2


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``lib``'s launch function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crop_tail_launch.argtypes = [p, p, ctypes.POINTER(ctypes.c_int), i,
                                     i, i, i, ctypes.POINTER(ctypes.c_float),
                                     i, ctypes.c_float, p]
    lib.crop_tail_launch.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_cuda_build.load("crop_tail"))
