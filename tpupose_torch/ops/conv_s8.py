"""int8 1x1 and 3x3 SAME convolution of one input group with the fused w8a8
epilogue: the CUDA kernel's wrapper, its plain PyTorch version, the weight
packer, the kernel's limits and its tile choice.

The port's redesign of the Pallas TPU kernel ``tpupose/ops/pallas/
requant.py::requant_epilogue`` for Hopper: rather than finishing an int32
accumulator that im2col and ``torch._int_mm`` left in device memory, the
epilogue is fused into its producer, an implicit GEMM on the int8 tensor
cores (``tpupose_torch/csrc/conv_s8.cu``), as ``tpupose/quant.py::_qconv``
fuses it under XLA.  ``conv_s8`` routes by the device of its input only:
CPU tensors take ``conv_s8_reference`` (im2col, ``torch._int_mm``, the
plain epilogue); CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.conv7 import (MAX_SMEM_BYTES, NUM_SMS, _round_up,
                                     im2col_acc_s8)
from tpupose_torch.ops.requant import requant_epilogue_reference

KSIZES = (1, 3)
UNIT_K = 32           # kUnitK: channels of one K unit (one mma k32 step)
UNITS_PER_WARP = 4    # kUnitsPerWarp: units each K warp takes per stage
STAGES = 3            # kStages: depth of the weight ring
TILE_W = 16           # kTileW: output columns of a block's tile
# The kernel's block tiles by index (conv_s8_launch's `tile`): output rows
# (2 per M warp), warps along K, output channels of a block.
TILES = ((4, 4, 32), (8, 4, 32), (8, 2, 64), (8, 1, 64), (16, 1, 64))
MIN_TILE_N = min(n for _, _, n in TILES)


def c_pad(channels: int) -> int:
    """Channels as the kernel stages them: a multiple of ``UNIT_K``, the
    extra channels zero."""
    return _round_up(channels, UNIT_K)


def conv_s8_reference(x: torch.Tensor, kernel_q: torch.Tensor,
                      mult: torch.Tensor, bias: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: an im2col int32 accumulator, then the plain
    epilogue (clip to [0, 127])."""
    return requant_epilogue_reference([im2col_acc_s8(x, kernel_q)], [mult],
                                      bias, relu, lo=0.0)


def pack_conv_s8_weights(kq: torch.Tensor) -> torch.Tensor:
    """(k, k, C, O) int8 HWIO -> the kernel's (k*k, O, C_pad) int8: tap
    ``dy * k + dx``, then output channel, then input channel (K contiguous
    per output channel, the B fragments' layout), C zero-padded to
    ``c_pad(C)``.  Done once per layer, at ``quantize()``."""
    k, _, c, o = kq.shape
    kp = kq.new_zeros((k * k, o, c_pad(c)))
    kp[:, :, :c] = kq.reshape(k * k, c, o).transpose(1, 2)
    return kp


def smem_bytes(channels: int, ksize: int, tile: Optional[int] = None) -> int:
    """Shared memory of one block (``csrc/conv_s8.cu::smem_bytes``): the
    haloed input tile at a pixel stride of ``C_pad + 16`` bytes, the weight
    ring of ``STAGES`` stages (per output channel a row of the stage's
    units and 16 bytes), which the K warps' int32 partials reuse, and one
    int per K unit.  ``tile``: an index into ``TILES``; None gives the
    largest over all tiles."""
    cp = c_pad(channels)
    r = ksize // 2
    units = ksize * ksize * cp // UNIT_K
    out = 0
    for rows, warps_k, tile_n in (TILES if tile is None
                                  else (TILES[tile],)):
        ring = STAGES * tile_n * (warps_k * UNITS_PER_WARP * UNIT_K + 16)
        partial = (warps_k * (rows // 2) * 2 * (tile_n // 8) * 4 * 32 * 4
                   if warps_k > 1 else 0)
        out = max(out, (rows + 2 * r) * (TILE_W + 2 * r) * (cp + 16)
                  + max(ring, partial) + 4 * units)
    return out


def blocks(b: int, h: int, w: int, o: int, tile: int) -> int:
    """Blocks of one launch with tile ``tile``."""
    rows, _, tile_n = TILES[tile]
    return -(-h // rows) * -(-w // TILE_W) * (o // tile_n) * b


@functools.lru_cache(maxsize=None)
def pick_tile(b: int, h: int, w: int, c: int, o: int, ksize: int) -> int:
    """The tile for a layer on a (b, h, w) grid, the fastest of ``TILES``
    at each layer ``chip_smoke.py`` times (H100 80GB HBM3 at 700 W,
    CUDA-graph replays; ms at the tiles in ``TILES``' order):

    - conv1_2, (1, 368, 496) 64 -> 64, 3x3: 0.0997, 0.1061, 0.0562,
      0.0510, 0.0476: the 16-row tile, 713 blocks;
    - conv3_2, (1, 92, 124) 256 -> 256, 3x3: 0.0672, 0.0647, 0.0446,
      0.0643, 0.0629: 8 rows, 2 K warps, 64 channels, 384 blocks;
    - conv4_2, (1, 46, 62) 512 -> 512, 3x3: 0.0596, 0.0541, 0.0689,
      0.0996, 0.0592: 8 rows, 4 K warps, 32 channels, 384 blocks;
    - conv5_4, (1, 46, 62) 128 -> 512, 1x1: 0.0106, 0.0118, 0.0081,
      0.0079, 0.0082: 8 rows, one K warp (4 K units), 192 blocks;
    - Mconv6, (1, 46, 62) 128 -> 128, 1x1: 0.0043, 0.0049, 0.0059,
      0.0071, 0.0080: 4 rows, 4 K warps, 192 blocks.

    So: the widest work per block that still gives two waves of blocks,
    one K warp where K is a few units, and the K split where blocks are
    few."""
    two_waves = 2 * NUM_SMS
    if o % 64 == 0:
        if blocks(b, h, w, o, 4) >= two_waves:
            return 4
        if blocks(b, h, w, o, 2) >= two_waves:
            return 2
        if (ksize * ksize * c_pad(c) // UNIT_K <= UNITS_PER_WARP
                and blocks(b, h, w, o, 3) >= NUM_SMS):
            return 3
    return 1 if blocks(b, h, w, o, 1) >= two_waves else 0


def check_inputs(x: torch.Tensor, kernel_q: torch.Tensor,
                 mult: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise ``ValueError`` unless an int8 (B, H, W, C) input, an int8
    (k, k, C, O) kernel with k in ``KSIZES`` and float32 (O,) mult and bias
    fit one another on one device."""
    xs, ks = x.shape, kernel_q.shape
    dev = x.device
    if x.dtype != torch.int8 or len(xs) != 4:
        raise ValueError(f"conv_s8: the input must be int8 (B, H, W, C), "
                         f"got {x.dtype} {tuple(xs)}")
    if (kernel_q.dtype != torch.int8 or len(ks) != 4 or ks[0] != ks[1]
            or ks[0] not in KSIZES or ks[2] != xs[3]
            or kernel_q.device != dev):
        raise ValueError(f"conv_s8: kernel {kernel_q.dtype} {tuple(ks)} on "
                         f"{kernel_q.device} is not a (k, k, {xs[3]}, O) "
                         f"int8 kernel with k in {KSIZES} on {dev}")
    o = ks[3]
    for t in (mult, bias):
        if (t.dtype != torch.float32 or t.shape != (o,)
                or t.device != dev):
            raise ValueError(f"conv_s8: mult and bias must be float32 "
                             f"({o},) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


@functools.lru_cache(maxsize=None)
def check_kernel_limits(channels: int, out_channels: int,
                        ksize: int) -> None:
    """Raise ``ValueError`` where the CUDA kernel cannot take a layer:
    ksize not in ``KSIZES``, outputs not a multiple of 32, or a block's
    shared memory, at the largest tile, beyond what one Hopper block may
    use."""
    if ksize not in KSIZES:
        raise ValueError(f"conv_s8: ksize {ksize}; the kernel takes "
                         f"{KSIZES}")
    if out_channels % MIN_TILE_N:
        raise ValueError(f"conv_s8: {out_channels} output channels, not a "
                         f"multiple of {MIN_TILE_N}")
    smem = smem_bytes(channels, ksize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv_s8: {smem} bytes of shared memory for "
                         f"{channels} channels exceed {MAX_SMEM_BYTES}")


def conv_s8(x: torch.Tensor, kernel_q: torch.Tensor, mult: torch.Tensor,
            bias: torch.Tensor, relu: bool = True,
            packed: Optional[torch.Tensor] = None,
            tile: Optional[int] = None) -> torch.Tensor:
    """Fused int8 k x k SAME conv (k = 1 or 3) + w8a8 requantize.

    ``x``: (B, H, W, C) int8; ``kernel_q``: (k, k, C, O) int8 HWIO;
    ``mult``, ``bias``: (O,) float32.  Returns (B, H, W, O) int8 equal to
    ``conv_s8_reference``.  ``packed``: ``kernel_q`` already through
    ``pack_conv_s8_weights`` (packed here if None).  ``tile``: an index
    into ``TILES``, ``pick_tile``'s choice if None.

    CPU tensors run the plain version; CUDA tensors run the kernel, which
    adds one to ``conv_s8.launches`` per launch and to
    ``conv_s8.shapes[(B, H, W, C, O, k)]``.  What the kernel cannot take
    raises ``ValueError`` on every device."""
    check_inputs(x, kernel_q, mult, bias)
    b, h, w, c = x.shape
    k, o = kernel_q.shape[0], kernel_q.shape[3]
    check_kernel_limits(c, o, k)
    dev = x.device
    if dev.type == "cpu":
        return conv_s8_reference(x, kernel_q, mult, bias, relu)
    if dev.type != "cuda":
        raise ValueError(f"conv_s8: unsupported device {dev}")
    if tile is None:
        tile = pick_tile(b, h, w, c, o, k)
    if not 0 <= tile < len(TILES) or o % TILES[tile][2]:
        raise ValueError(f"conv_s8: no tile {tile} for {o} outputs; the "
                         f"kernel has {TILES}")
    if not (x.is_contiguous() and mult.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("conv_s8: the kernel takes contiguous tensors")
    cp = c_pad(c)
    if packed is None:
        packed = pack_conv_s8_weights(kernel_q)
    if (packed.dtype != torch.int8 or packed.shape != (k * k, o, cp)
            or packed.device != dev or not packed.is_contiguous()):
        raise ValueError(f"conv_s8: packed weights must be contiguous int8 "
                         f"({k * k}, {o}, {cp}) on {dev}")
    x_ptr, w_ptr = x.data_ptr(), packed.data_ptr()
    # cp.async copies 16-byte chunks of the weights and of inputs whose
    # pixels are whole chunks.
    if w_ptr % 16 or (c % 16 == 0 and x_ptr % 16):
        raise ValueError("conv_s8: the input and the packed weights must be "
                         "16-byte aligned")
    out = torch.empty((b, h, w, o), dtype=torch.int8, device=dev)
    lib = _library()
    args = (x_ptr, w_ptr, mult.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, c, cp, o, k, int(relu), tile)
    if dev.index in (None, torch.cuda.current_device()):
        err = lib.conv_s8_launch(*args,
                                 torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.conv_s8_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, "conv_s8", err)
    conv_s8.launches += 1
    conv_s8.shapes[(b, h, w, c, o, k)] += 1
    return out


conv_s8.launches = 0
conv_s8.shapes = collections.Counter()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("conv_s8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_s8_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                   p]
    lib.conv_s8_launch.restype = i
    return lib
