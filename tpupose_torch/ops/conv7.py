"""int8 7x7 SAME convolution with the fused w8a8 epilogue: the CUDA kernel's
wrapper, its plain PyTorch version, and the im2col int8 convolution they
share.

Replaces the Pallas TPU kernel ``tpupose/ops/pallas/conv7.py::conv7_s8``.
``conv7_s8`` routes by the device of its inputs only: CPU tensors take
``conv7_s8_reference`` (im2col, ``torch._int_mm``, the plain epilogue);
CUDA tensors launch ``tpupose_torch/csrc/conv7_s8.cu``, an implicit GEMM on
the int8 tensor cores, or raise.  There is no grid-size cut: PyTorch has no
int8 convolution on the card, so the kernel takes every 7x7 layer it is
given.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.requant import requant_epilogue_reference

MAX_GROUPS = 4        # CONV7_MAX_GROUPS in csrc/conv7_s8.cu
K_STEP = 32           # channels per mma k step: C pads to a multiple
TILE_W = 16           # kTileW: output columns of a block's tile
TILE_N = 32           # kTileN: output channels of a block
TAPS_PER_STEP = 4     # kTapsPerStep: warps along K, one tap each per step
STAGES = 3            # kStages: depth of the weight ring, in steps
# The kernel's block tiles by index (conv7_s8_launch's `tile`): output rows
# of a block, 16 columns wide; 2 rows per warp along M.
TILE_ROWS = (4, 8)
MAX_SMEM_BYTES = 232448     # shared memory one Hopper block may use
NUM_SMS = 132               # streaming multiprocessors of an H100 SXM


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, through
    ``torch._int_mm``.  On CUDA it asks for K and N multiples of 8, and
    cuBLASLt rejects some shapes whose M is not a multiple of 32 (M = 17 to
    33, 713 or 2852 at K <= 64 and N >= 40; measured on an H100 with
    PyTorch 2.11 / CUDA 12.8).  So M is padded to a multiple of 32 and K, N
    to multiples of 8, with zeros, on every device, and the result cut back:
    the integers are unchanged."""
    m, k = a.shape
    n = b.shape[1]
    pad_m = _round_up(m, 32) - m
    pad_k = _round_up(k, 8) - k
    pad_n = _round_up(n, 8) - n
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if pad_m or pad_n else out


def im2col_acc_s8(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """int8 k x k SAME convolution as one patch matmul: the k*k shifted
    windows of the zero-padded input laid out on channels (tap ``dy * k +
    dx``, then channel), then one (B*H*W, k*k*C) @ (k*k*C, O) int8 matmul
    into int32.  The windows are two ``unfold`` views and one copy, so a
    traced program holds a handful of nodes per layer, not k*k slices.

    xq: (B, H, W, C) int8; kq: (k, k, C, O) int8 (HWIO) -> (B, H, W, O)
    int32, bit-equal to an integer convolution."""
    b, h, w, c = xq.shape
    k, o = kq.shape[0], kq.shape[-1]
    if k == 1:
        patches = xq.reshape(b * h * w, c)
    else:
        r = k // 2
        xp = F.pad(xq, (0, 0, r, r, r, r))
        # (B, H, W, C, k_dy, k_dx) -> (B, H, W, k_dy, k_dx, C)
        windows = xp.unfold(1, k, 1).unfold(2, k, 1)
        patches = windows.permute(0, 1, 2, 4, 5, 3).reshape(b * h * w,
                                                            k * k * c)
    return int_mm(patches, kq.reshape(k * k * c, o)).reshape(b, h, w, o)


def conv7_s8_reference(parts: Sequence[torch.Tensor],
                       kernels_q: Sequence[torch.Tensor],
                       mults: Sequence[torch.Tensor], bias: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: per group an im2col int32 accumulator, then
    the plain epilogue (clip to [0, 127])."""
    accs = [im2col_acc_s8(x, k) for x, k in zip(parts, kernels_q)]
    return requant_epilogue_reference(accs, mults, bias, relu, lo=0.0)


def c_pad(channels: int) -> int:
    """Channels of a group as the kernel stages them: a multiple of
    ``K_STEP``, the extra channels zero."""
    return _round_up(channels, K_STEP)


def pack_conv7_weights(kq: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, O) int8 HWIO -> the kernel's (49, O, C_pad) int8: tap
    ``dy * 7 + dx``, then output channel, then input channel (K contiguous
    per output channel, the B fragments' layout), C zero-padded to
    ``c_pad(C)``.  Done once per layer, at ``quantize()``."""
    _, _, c, o = kq.shape
    kp = kq.new_zeros((49, o, c_pad(c)))
    kp[:, :, :c] = kq.reshape(49, c, o).transpose(1, 2)
    return kp


def smem_bytes(channels: Sequence[int], tile: Optional[int] = None) -> int:
    """Shared memory of one block for groups of these channel counts: the
    haloed input tile, then the weight ring (``STAGES`` steps of
    ``TAPS_PER_STEP`` taps of ``TILE_N`` rows), which the cross-warp sum of
    the int32 partials reuses, at a per-pixel stride of ``max C_pad + 16``
    bytes.  ``tile``: an index into ``TILE_ROWS``; None gives the largest
    over all tiles."""
    stride = max(c_pad(c) for c in channels) + 16
    rows = TILE_ROWS if tile is None else (TILE_ROWS[tile],)
    return max((r + 6) * (TILE_W + 6) * stride
               + max(STAGES * TAPS_PER_STEP * TILE_N * stride,
                     TAPS_PER_STEP * (r // 2) * 32 * 32 * 4)
               for r in rows)


def blocks(b: int, h: int, w: int, o: int, tile: int) -> int:
    """Blocks of one launch with tile ``tile``."""
    return -(-h // TILE_ROWS[tile]) * -(-w // TILE_W) * (o // TILE_N) * b


@functools.lru_cache(maxsize=None)
def pick_tile(b: int, h: int, w: int, o: int) -> int:
    """The tile for a (b, h, w) grid with o outputs: 8 rows where that
    still gives half a wave of blocks on the card's SMs, else 4.  Measured
    on an H100 (``csrc/conv7_s8.cu``'s note): taller tiles re-read the
    layer's weights fewer times and win once the grid fills most SMs."""
    return 1 if blocks(b, h, w, o, 1) >= NUM_SMS // 2 else 0


def check_inputs(parts: Sequence[torch.Tensor],
                 kernels_q: Sequence[torch.Tensor],
                 mults: Sequence[torch.Tensor], bias: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the groups, kernels, mults and bias fit
    one another: G int8 (B, H, W, C_g) groups on one device, G int8
    (7, 7, C_g, O) kernels, G float32 (O,) mults and a float32 (O,) bias."""
    g = len(parts)
    if not (g >= 1 and len(kernels_q) == g and len(mults) == g):
        raise ValueError(f"conv7_s8: {g} groups, {len(kernels_q)} kernels, "
                         f"{len(mults)} mults")
    # Each shape is read once: the checks run before every launch.
    bhw = parts[0].shape[:3]
    o = kernels_q[0].shape[-1]
    dev = parts[0].device
    for x, k in zip(parts, kernels_q):
        xs = x.shape
        if (x.dtype != torch.int8 or len(xs) != 4 or xs[:3] != bhw
                or x.device != dev):
            raise ValueError(f"conv7_s8: groups must be int8 "
                             f"{(*bhw, 'C')} on {dev}, got {x.dtype} "
                             f"{tuple(xs)} on {x.device}")
        ks = k.shape
        if (k.dtype != torch.int8 or ks != (7, 7, xs[-1], o)
                or k.device != dev):
            raise ValueError(f"conv7_s8: kernel {k.dtype} {tuple(ks)} "
                             f"does not fit a {tuple(xs)} group with "
                             f"{o} outputs on {dev}")
    for t in (*mults, bias):
        if (t.dtype != torch.float32 or t.shape != (o,)
                or t.device != dev):
            raise ValueError(f"conv7_s8: mults and bias must be float32 "
                             f"({o},) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def check_kernel_limits(channels: Sequence[int], out_channels: int) -> None:
    """Raise ``ValueError`` where the CUDA kernel cannot take a layer: more
    than ``MAX_GROUPS`` groups, outputs not a multiple of ``TILE_N``, or a
    block's shared memory, at the largest tile, beyond what one Hopper block
    may use."""
    _check_kernel_limits(tuple(channels), out_channels)


@functools.lru_cache(maxsize=None)
def _check_kernel_limits(channels, out_channels: int) -> None:
    if len(channels) > MAX_GROUPS:
        raise ValueError(f"conv7_s8: {len(channels)} groups; the kernel "
                         f"takes 1 to {MAX_GROUPS}")
    if out_channels % TILE_N:
        raise ValueError(f"conv7_s8: {out_channels} output channels, not a "
                         f"multiple of {TILE_N}")
    smem = smem_bytes(channels)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv7_s8: {smem} bytes of shared memory for "
                         f"channels {list(channels)} exceed {MAX_SMEM_BYTES}")


def conv7_s8(parts: Sequence[torch.Tensor],
             kernels_q: Sequence[torch.Tensor],
             mults: Sequence[torch.Tensor], bias: torch.Tensor,
             relu: bool = True,
             packed: Optional[Sequence[torch.Tensor]] = None,
             tile: Optional[int] = None) -> torch.Tensor:
    """Fused int8 7x7 SAME conv + w8a8 requantize.

    ``parts``: G input groups (B, H, W, C_g) int8 (the refine stages' concat
    members; a 1-tuple elsewhere); ``kernels_q``: G of (7, 7, C_g, O) int8;
    ``mults``: G of (O,) float32; ``bias``: (O,) float32.  Returns
    (B, H, W, O) int8 equal to ``conv7_s8_reference``.  ``packed``: the
    kernels already through ``pack_conv7_weights`` (packed here if None).
    ``tile``: an index into ``TILE_ROWS``, ``pick_tile``'s choice if
    None.

    CPU tensors run the plain version; CUDA tensors run the kernel, which
    adds one to ``conv7_s8.launches`` per launch and to
    ``conv7_s8.shapes[(B, H, W, (C_0, ..., C_G-1))]``.  Inputs that do not
    fit raise ``ValueError`` on every device."""
    check_inputs(parts, kernels_q, mults, bias)
    dev = parts[0].device
    if dev.type == "cpu":
        return conv7_s8_reference(parts, kernels_q, mults, bias, relu)
    if dev.type != "cuda":
        raise ValueError(f"conv7_s8: unsupported device {dev}")
    b, h, w, _ = parts[0].shape
    o = kernels_q[0].shape[-1]
    channels = tuple(x.shape[-1] for x in parts)
    check_kernel_limits(channels, o)
    if tile is None:
        tile = pick_tile(b, h, w, o)
    if not 0 <= tile < len(TILE_ROWS):
        raise ValueError(f"conv7_s8: no tile {tile}; the kernel has "
                         f"{len(TILE_ROWS)}")
    if not all(x.is_contiguous() for x in parts):
        raise ValueError("conv7_s8: the kernel takes contiguous groups")
    if packed is None:
        packed = [pack_conv7_weights(k) for k in kernels_q]
    c_pads = [c_pad(c) for c in channels]
    for p, cp in zip(packed, c_pads):
        if (p.dtype != torch.int8 or tuple(p.shape) != (49, o, cp)
                or p.device != dev or not p.is_contiguous()):
            raise ValueError(f"conv7_s8: packed weights must be contiguous "
                             f"int8 (49, {o}, {cp}) on {dev}")
    xs = [x.data_ptr() for x in parts]
    ws = [p.data_ptr() for p in packed]
    # cp.async copies 16-byte chunks of the weights and of the groups whose
    # pixels are whole chunks.
    if any(ptr % 16 for ptr, c in zip(xs, channels) if c % 16 == 0) or any(
            ptr % 16 for ptr in ws):
        raise ValueError("conv7_s8: groups and packed weights must be "
                         "16-byte aligned")
    if not all(m.is_contiguous() for m in mults):
        raise ValueError("conv7_s8: the kernel takes contiguous mults")
    bias = bias.contiguous()
    out = torch.empty((b, h, w, o), dtype=torch.int8, device=dev)
    lib = _library()
    g = len(parts)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    args = ((vp * g)(*xs), (vp * g)(*ws),
            (vp * g)(*[m.data_ptr() for m in mults]), (ci * g)(*channels),
            (ci * g)(*c_pads), g, bias.data_ptr(), out.data_ptr(), b, h, w,
            o, int(relu), tile)
    if dev.index in (None, torch.cuda.current_device()):
        err = lib.conv7_s8_launch(
            *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.conv7_s8_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, "conv7_s8", err)
    conv7_s8.launches += 1
    conv7_s8.shapes[(b, h, w, channels)] += 1
    return out


conv7_s8.launches = 0
conv7_s8.shapes = collections.Counter()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("conv7_s8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv7_s8_launch.argtypes = [
        ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(p),
        ctypes.POINTER(i), ctypes.POINTER(i), i, p, p, i, i, i, i, i, i, p]
    lib.conv7_s8_launch.restype = i
    return lib
