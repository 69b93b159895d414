"""Resizes as dense interpolation matmuls, cv2's uint8 bilinear resize on
the host (compiled, ``native/resize_u8_host.cpp``, with its numpy plain
version) and a numpy emulation of its bicubic one (port of
``tpupose/ops/resize.py``), and the batched uint8 bilinear resize of packed
images on the card.

The three matrix builders and ``compute_optimal_size`` are copies of the JAX
module's numpy code (that module imports ``jax.numpy``, which this package
must not).  ``resize_hw`` runs ``out = M_h @ x @ M_w^T`` as two float32
``torch.matmul`` calls; callers pin the matmul precision to ``"highest"``
(TF32 would cost ~1e-3 and move integer peak coordinates).

``resize_u8_linear_batch`` resizes a batch of HWC images of different
sizes, packed back to back in one uint8 buffer (``pack_u8_images``), each
optionally mirrored, to one size: ``resize_u8_linear``'s bytes.  It routes
by the buffer's device only: a CPU tensor takes the plain PyTorch version
``resize_u8_linear_batch_plain``; a CUDA tensor launches
``tpupose_torch/csrc/resize_u8.cu`` (built at its first launch by
``ops/_cuda_build.py``) or raises.  There is no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpupose_torch import native
from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.upload import to_device


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
    mh = to_device(builder(in_h, out_h), x.device)
    mw = to_device(builder(in_w, out_w), x.device)
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


def _check_u8_image(img: np.ndarray) -> None:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 HW or HWC image, got "
                         f"{img.dtype} {img.shape}")


def resize_u8_linear_plain(img: np.ndarray, size: Tuple[int, int]
                           ) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` for uint8 HW or HWC images, in numpy: the
    plain version of ``resize_u8_linear``.

    Emulates cv2's fixed-point INTER_LINEAR: 11-bit coefficients, an exact
    integer horizontal pass, and the vertical pass with the descale of its
    SIMD path, ``((S0>>4)*b0>>16) + ((S1>>4)*b1>>16) + 2 >> 2``.  ``size``
    is ``(width, height)`` as cv2 takes it.
    """
    img = np.asarray(img)
    _check_u8_image(img)
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


@functools.lru_cache(maxsize=64)
def _host_taps(in_size: int, out_size: int, clamp: bool):
    """``_cv2_linear_taps`` as read-only contiguous int32 arrays."""
    taps = tuple(np.ascontiguousarray(t, np.int32)
                 for t in _cv2_linear_taps(in_size, out_size, clamp))
    for t in taps:
        t.flags.writeable = False
    return taps


@functools.lru_cache(maxsize=1)
def _host_library() -> ctypes.CDLL:
    return native.load_resize_u8()


def resize_u8_linear(img: np.ndarray, size: Tuple[int, int],
                     out: np.ndarray = None) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` for uint8 HW or HWC images (any channel
    count): ``resize_u8_linear_plain``'s bytes, computed by the compiled
    ``native/resize_u8_host.cpp`` on one host thread (cv2's separable
    fixed-point INTER_LINEAR with buffered rows).  The library is built at
    first use; a failed build raises, there is no fallback.

    ``size`` is ``(width, height)`` as cv2 takes it.  ``out``, if given, is
    a C-contiguous uint8 array of the result's shape that receives it (a
    slot of a batch) and is returned.  A non-contiguous input (a mirrored
    view) is made contiguous first; an input already of the size is copied.
    Each image the compiled routine resizes adds one to
    ``resize_u8_linear.calls``."""
    img = np.asarray(img)
    _check_u8_image(img)
    w, h = (int(v) for v in size)
    in_h, in_w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    shape = (h, w) + img.shape[2:]
    if min(in_h, in_w, cn, h, w) < 1 or max(h * w, in_w) * cn > 2**31 - 1:
        raise ValueError(f"cannot resize a {img.shape} image to {size}")
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (not isinstance(out, np.ndarray) or out.dtype != np.uint8
          or out.shape != shape or not out.flags.c_contiguous
          or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous uint8 array "
                         f"of shape {shape}")
    if (in_h, in_w) == (h, w):
        out[...] = img
        return out
    src = np.ascontiguousarray(img)
    sx, a0, a1 = _host_taps(in_w, w, True)
    sy, b0, b1 = _host_taps(in_h, h, False)
    rc = _host_library().resize_u8_linear_host(
        src.ctypes.data, in_h, in_w, cn, out.ctypes.data, h, w,
        sx.ctypes.data, a0.ctypes.data, a1.ctypes.data,
        sy.ctypes.data, b0.ctypes.data, b1.ctypes.data)
    if rc != 0:
        raise MemoryError("resize_u8_linear: no memory for the row buffers")
    with _calls_lock:
        resize_u8_linear.calls += 1
    return out


resize_u8_linear.calls = 0
_calls_lock = threading.Lock()


# Must equal RESIZE_U8_MAX_ITEMS and RESIZE_U8_MAX_OUT_W in
# csrc/resize_u8.cu: the items one launch carries in its parameters, and
# the widest output row.
MAX_ITEMS = 64
MAX_OUT_W = 2048


def pack_u8_images(images: Sequence[np.ndarray], mirrors: Sequence[bool],
                   pin_memory: bool = False
                   ) -> Tuple[torch.Tensor, List[Tuple[int, int, int, bool]]]:
    """HWC uint8 3-channel images -> one flat uint8 CPU tensor holding them
    back to back, and per image the ``(byte offset, h, w, mirror)``
    descriptor ``resize_u8_linear_batch`` takes.

    ``pin_memory=True`` puts the tensor in pinned memory, ready for a
    ``.to(device, non_blocking=True)`` whose copy the caching host allocator
    guards.  numpy writes the images into it on one thread: staging a
    pageable buffer with ``Tensor.pin_memory()`` copies through torch's
    intra-op threads, which cost 0.4-3.9 ms a hand request (8 crops, ~0.4
    MB) on an 8-core H100 host in a request loop, against 0.12-0.15 ms with
    one thread."""
    images = [np.asarray(img) for img in images]
    for img in images:
        if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3
                or img.size == 0):
            raise ValueError(f"expected non-empty uint8 HWC 3-channel "
                             f"images, got {img.dtype} {img.shape}")
    packed = torch.empty(sum(img.size for img in images), dtype=torch.uint8,
                         pin_memory=pin_memory)
    flat = packed.numpy()
    descriptors, o = [], 0
    for img, mirror in zip(images, mirrors, strict=True):
        flat[o:o + img.size].reshape(img.shape)[...] = img
        descriptors.append((o, img.shape[0], img.shape[1], bool(mirror)))
        o += img.size
    return packed, descriptors


def resize_u8_linear_batch_plain(packed: torch.Tensor, descriptors,
                                 size: Tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version of ``resize_u8_linear_batch``, on any
    device: int32 tensor arithmetic, item by item, with
    ``resize_u8_linear``'s taps and shifts; a mirrored item reads source
    column ``w - 1 - x``."""
    out_w, out_h = size
    dev = packed.device
    out = torch.empty((len(descriptors), out_h, out_w, 3), dtype=torch.uint8,
                      device=dev)

    def taps(in_size, out_size, clamp):
        return [torch.from_numpy(t).to(dev)
                for t in _cv2_linear_taps(in_size, out_size, clamp)]

    for i, (o, h, w, mirror) in enumerate(descriptors):
        img = packed[o:o + h * w * 3].view(h, w, 3).to(torch.int32)
        sx, a0, a1 = taps(w, out_w, True)
        sx1 = (sx + 1).clamp(max=w - 1)
        if mirror:
            sx, sx1 = w - 1 - sx, w - 1 - sx1
        rows = (img[:, sx] * a0[None, :, None]
                + img[:, sx1] * a1[None, :, None]) >> 4
        sy, b0, b1 = taps(h, out_h, False)
        s0 = rows[sy.clamp(0, h - 1)]
        s1 = rows[(sy + 1).clamp(0, h - 1)]
        v = (((s0 * b0[:, None, None]) >> 16)
             + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
        out[i] = v.clamp(0, 255).to(torch.uint8)
    return out


def _check_batch(packed, descriptors, size):
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.uint8 \
            or packed.dim() != 1:
        raise ValueError(f"resize_u8_linear_batch: expected a 1-D uint8 "
                         f"tensor, got {getattr(packed, 'dtype', packed)} "
                         f"{tuple(getattr(packed, 'shape', ()))}")
    if not packed.is_contiguous():
        raise ValueError("resize_u8_linear_batch: input must be contiguous")
    out_w, out_h = size
    if not (1 <= out_w <= MAX_OUT_W and out_h >= 1):
        raise ValueError(f"resize_u8_linear_batch: output size {size}; the "
                         f"kernel takes widths 1 to {MAX_OUT_W}")
    n = packed.numel()
    for o, h, w, _ in descriptors:
        if h < 1 or w < 1 or h * w * 3 > 2**31 - 1 or o < 0 \
                or o + h * w * 3 > n:
            raise ValueError(f"resize_u8_linear_batch: item (offset {o}, "
                             f"{h}x{w}x3) outside the {n}-byte buffer")


def resize_u8_linear_batch(packed: torch.Tensor, descriptors,
                           size: Tuple[int, int]) -> torch.Tensor:
    """Resize packed uint8 HWC 3-channel images to one size, each as
    ``resize_u8_linear`` does (mirrored first where its flag says).

    packed: 1-D uint8 tensor; descriptors: ``(byte offset, h, w, mirror)``
    per image (``pack_u8_images``); size: ``(width, height)`` as cv2 takes
    it.  Returns (B, height, width, 3) uint8 on ``packed``'s device.  CPU
    tensors run ``resize_u8_linear_batch_plain``; CUDA tensors run the
    kernel, ``MAX_ITEMS`` images a launch, which adds one to
    ``resize_u8_linear_batch.launches`` per launch and to
    ``resize_u8_linear_batch.shapes[(height, width, ((h, w, mirror), ...))]``
    for the launch's images, and the images to
    ``resize_u8_linear_batch.images``."""
    descriptors = [(int(o), int(h), int(w), bool(m))
                   for o, h, w, m in descriptors]
    _check_batch(packed, descriptors, size)
    dev = packed.device
    if dev.type == "cpu":
        return resize_u8_linear_batch_plain(packed, descriptors, size)
    if dev.type != "cuda":
        raise ValueError(f"resize_u8_linear_batch: unsupported device {dev}")
    out_w, out_h = size
    out = torch.empty((len(descriptors), out_h, out_w, 3), dtype=torch.uint8,
                      device=dev)
    with torch.cuda.device(dev):
        launches = _launch(_library(), packed, descriptors, out,
                           torch.cuda.current_stream().cuda_stream)
    resize_u8_linear_batch.launches += launches
    resize_u8_linear_batch.images += len(descriptors)
    for i in range(0, len(descriptors), MAX_ITEMS):
        resize_u8_linear_batch.shapes[(out_h, out_w, tuple(
            (h, w, m) for _, h, w, m in descriptors[i:i + MAX_ITEMS]))] += 1
    return out


resize_u8_linear_batch.launches = 0
resize_u8_linear_batch.images = 0
resize_u8_linear_batch.shapes = collections.Counter()


def _launch(lib, packed, descriptors, out, stream) -> int:
    """Launch on ``lib`` (the built library; the tests pass a host build of
    the same source), on ``stream``, ``MAX_ITEMS`` images a launch, into
    ``out``; returns the number of launches."""
    _, out_h, out_w, _ = out.shape
    item_bytes = out_h * out_w * 3
    launches = 0
    for i in range(0, len(descriptors), MAX_ITEMS):
        chunk = descriptors[i:i + MAX_ITEMS]
        items = (ctypes.c_longlong * (4 * len(chunk)))(
            *[v for d in chunk for v in d])
        err = lib.resize_u8_launch(packed.data_ptr(),
                                   out.data_ptr() + i * item_bytes, items,
                                   len(chunk), out_h, out_w, stream)
        _cuda_build.check(lib, "resize_u8", err)
        launches += 1
    return launches


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``lib``'s launch function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resize_u8_launch.argtypes = [p, p, ctypes.POINTER(ctypes.c_longlong),
                                     i, i, i, p]
    lib.resize_u8_launch.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_cuda_build.load("resize_u8"))


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
    _check_u8_image(img)
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
