"""int8 1x1 and 3x3 SAME convolution of 1 to 4 input groups with the fused
w8a8 epilogue and activation: the CUDA kernel's wrapper, its plain PyTorch
version, the weight packer, the kernel's limits and its tile choice.

The port's redesign of the Pallas TPU kernel ``tpupose/ops/pallas/
requant.py::requant_epilogue`` for Hopper: rather than finishing an int32
accumulator that im2col and ``torch._int_mm`` left in device memory, the
epilogue is fused into its producer, an implicit GEMM on the int8 tensor
cores (``tpupose_torch/csrc/conv_s8.cu``), as ``tpupose/quant.py::_qconv``
fuses it under XLA.  The input groups are the members of a concatenation
(BODY_25's dense blocks and stage inputs), each with its own kernel and
mult; the activation is ``"relu"`` (the JAX package's nets: store in
[0, 127]), ``"prelu"`` (per-channel slopes, store in [-127, 127]) or
``"none"`` (store in [-127, 127]).  ``conv_s8`` routes by the device of
its input only: CPU tensors take ``conv_s8_reference`` (im2col,
``torch._int_mm``, the plain epilogue); CUDA tensors launch the kernel, or
raise.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Union

import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.conv7 import (MAX_SMEM_BYTES, NUM_SMS, _round_up,
                                     im2col_acc_s8)
from tpupose_torch.ops.requant import ACTS, act_epilogue_reference

KSIZES = (1, 3)
UNIT_K = 32           # kUnitK: channels of one K unit (one mma k32 step)
UNITS_PER_WARP = 4    # kUnitsPerWarp: units each K warp takes per stage
STAGES = 3            # kStages: depth of the weight ring
TILE_W = 16           # kTileW: output columns of a block's tile
# The kernel's block tiles by index (conv_s8_launch's `tile`): output rows
# (2 per M warp), warps along K, output channels of a block.
TILES = ((4, 4, 32), (8, 4, 32), (8, 2, 64), (8, 1, 64), (16, 1, 64))
MIN_TILE_N = min(n for _, _, n in TILES)
MAX_GROUPS = 4        # kMaxGroups: input groups of one launch
# The tiles that take more than one group: their K warps split the N
# fragments, so a warp keeps few float32 sums from group to group.
GROUPED_TILES = tuple(t for t, (_, warps_k, _) in enumerate(TILES)
                      if warps_k > 1)

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_groups(t: Tensors) -> tuple:
    """A tensor (one group) or a sequence of groups, as a tuple."""
    return (t,) if isinstance(t, torch.Tensor) else tuple(t)


def c_pad(channels: int) -> int:
    """Channels as the kernel stages them: a multiple of ``UNIT_K``, the
    extra channels zero."""
    return _round_up(channels, UNIT_K)


def conv_s8_reference(parts: Tensors, kernels_q: Tensors, mults: Tensors,
                      bias: torch.Tensor, act: str = "relu",
                      slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: per group an im2col int32 accumulator, then
    the plain epilogue with the activation
    (``ops/requant.py::act_epilogue_reference``)."""
    accs = [im2col_acc_s8(x, k)
            for x, k in zip(_as_groups(parts), _as_groups(kernels_q))]
    return act_epilogue_reference(accs, _as_groups(mults), bias, act, slope)


def pack_conv_s8_weights(kq: torch.Tensor) -> torch.Tensor:
    """(k, k, C, O) int8 HWIO -> the kernel's (k*k, O, C_pad) int8: tap
    ``dy * k + dx``, then output channel, then input channel (K contiguous
    per output channel, the B fragments' layout), C zero-padded to
    ``c_pad(C)``.  Done once per layer, at ``quantize()``."""
    k, _, c, o = kq.shape
    kp = kq.new_zeros((k * k, o, c_pad(c)))
    kp[:, :, :c] = kq.reshape(k * k, c, o).transpose(1, 2)
    return kp


def smem_bytes(channels: Union[int, Sequence[int]], ksize: int,
               tile: Optional[int] = None) -> int:
    """Shared memory of one block (``csrc/conv_s8.cu::launch``): the
    haloed input tile at a pixel stride of ``C_pad + 16`` bytes of the
    widest group, the weight ring of ``STAGES`` stages (per output channel
    a row of the stage's units and 16 bytes), which the K warps' int32
    partials reuse, and one int per K unit of the widest group.
    ``channels``: one group's, or each group's; ``tile``: an index into
    ``TILES``; None gives the largest over all tiles."""
    cp = max(c_pad(c) for c in (
        (channels,) if isinstance(channels, int) else channels))
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
def pick_tile(b: int, h: int, w: int, c: int, o: int, ksize: int,
              groups: int = 1) -> int:
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
    few.

    BODY_25's PReLU layers at the 46x82 grid of a 720p frame (``c`` is the
    channels of all ``groups``; ms at each tile a layer takes, in
    ``TILES``' order; ``chip_smoke.py``'s phase 8b):

    - 128 -> 96, 3x3: 0.00832, 0.00758; 96 -> 96: 0.00720, 0.00685;
      [96, 96, 96] -> 96: 0.01791, 0.01740; [128, 52] -> 96: 0.01521,
      0.01402: 8 rows where O is 96 (not a multiple of 64), 108 blocks;
    - [128, 52] -> 128: 0.02290, 0.02511, 0.02061; [128, 26, 52] -> 128:
      0.02951, 0.03239, 0.02580; [128 x 3] -> 128: 0.03169, 0.03604,
      0.02984; [96 x 3] -> 256, 1x1: 0.02539, 0.02979, 0.02233;
      [128 x 3] -> 512, 1x1: 0.04269, 0.05200, 0.03425: a grouped layer
      on 8 rows, 2 K warps, 64 channels, which restages each group's
      tile once for twice the channels;
    - 128 -> 128: 0.01201, 0.01335, 0.01220, 0.01696, 0.01975; 256 ->
      128: 0.01905, 0.02119, 0.01941, 0.02753, 0.03245; 512 -> 256:
      0.0507, 0.0537, 0.0656, 0.0993, 0.0556: the rule above, 3 us off at
      512 -> 256.

    So, besides: a grouped layer (``GROUPED_TILES`` only) takes the 2-K-
    warp 64-channel tile where its O allows; an O that is not a multiple
    of 64 takes 8 rows from half a wave of blocks, as ``conv7.pick_tile``
    does."""
    two_waves = 2 * NUM_SMS
    if o % 64:
        return 1 if blocks(b, h, w, o, 1) >= NUM_SMS // 2 else 0
    if groups > 1:
        return 2
    if blocks(b, h, w, o, 4) >= two_waves:
        return 4
    if blocks(b, h, w, o, 2) >= two_waves:
        return 2
    if (ksize * ksize * c_pad(c) // UNIT_K <= UNITS_PER_WARP
            and blocks(b, h, w, o, 3) >= NUM_SMS):
        return 3
    return 1 if blocks(b, h, w, o, 1) >= two_waves else 0


def check_inputs(parts: Tensors, kernels_q: Tensors, mults: Tensors,
                 bias: torch.Tensor, act: str = "relu",
                 slope: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` unless G int8 (B, H, W, C_g) groups, G int8
    (k, k, C_g, O) kernels of one k in ``KSIZES``, G float32 (O,) mults, a
    float32 (O,) bias, an activation of ``ACTS`` and, for ``"prelu"``
    alone, float32 (O,) slopes fit one another on one device."""
    parts, kernels_q, mults = (_as_groups(parts), _as_groups(kernels_q),
                               _as_groups(mults))
    g = len(parts)
    if not (1 <= g and len(kernels_q) == g and len(mults) == g):
        raise ValueError(f"conv_s8: {g} groups, {len(kernels_q)} kernels, "
                         f"{len(mults)} mults")
    x0, k0 = parts[0], kernels_q[0]
    bhw, dev, kk, o = x0.shape[:3], x0.device, k0.shape[:2], k0.shape[-1]
    for x, kernel_q in zip(parts, kernels_q):
        xs, ks = x.shape, kernel_q.shape
        if (x.dtype != torch.int8 or len(xs) != 4 or xs[:3] != bhw
                or x.device != dev):
            raise ValueError(f"conv_s8: the input must be int8 (B, H, W, C) "
                             f"groups of one (B, H, W) on one device, got "
                             f"{x.dtype} {tuple(xs)} on {x.device}")
        if (kernel_q.dtype != torch.int8 or len(ks) != 4 or ks[0] != ks[1]
                or ks[0] not in KSIZES or ks[2] != xs[3] or ks[:2] != kk
                or ks[3] != o or kernel_q.device != dev):
            raise ValueError(f"conv_s8: kernel {kernel_q.dtype} {tuple(ks)} "
                             f"on {kernel_q.device} is not a (k, k, {xs[3]}, "
                             f"{o}) int8 kernel with k in {KSIZES} on {dev}")
    for t in (*mults, bias):
        if (t.dtype != torch.float32 or t.shape != (o,)
                or t.device != dev):
            raise ValueError(f"conv_s8: mult and bias must be float32 "
                             f"({o},) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if act not in ACTS:
        raise ValueError(f"conv_s8: activation {act!r}, not one of {ACTS}")
    if (act == "prelu") != (slope is not None):
        raise ValueError("conv_s8: slopes go with act='prelu' alone")
    if slope is not None and (slope.dtype != torch.float32
                              or slope.shape != (o,) or slope.device != dev):
        raise ValueError(f"conv_s8: slopes must be float32 ({o},) on {dev}, "
                         f"got {slope.dtype} {tuple(slope.shape)} on "
                         f"{slope.device}")


@functools.lru_cache(maxsize=None)
def check_kernel_limits(channels: Union[int, Sequence[int]],
                        out_channels: int, ksize: int) -> None:
    """Raise ``ValueError`` where the CUDA kernel cannot take a layer:
    ksize not in ``KSIZES``, more than ``MAX_GROUPS`` groups, outputs not a
    multiple of 32, or a block's shared memory, at the largest tile, beyond
    what one Hopper block may use.  ``channels``: one group's (an int) or
    each group's (a tuple)."""
    if not isinstance(channels, int) and len(channels) > MAX_GROUPS:
        raise ValueError(f"conv_s8: {len(channels)} groups; the kernel "
                         f"takes 1 to {MAX_GROUPS}")
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


def conv_s8(parts: Tensors, kernels_q: Tensors, mults: Tensors,
            bias: torch.Tensor, act: str = "relu",
            slope: Optional[torch.Tensor] = None,
            packed: Optional[Tensors] = None,
            tile: Optional[int] = None) -> torch.Tensor:
    """Fused int8 k x k SAME conv (k = 1 or 3) + w8a8 requantize.

    ``parts``: G input groups (B, H, W, C_g) int8, the members of a
    concatenation (a tensor is one group); ``kernels_q``: G of (k, k, C_g,
    O) int8 HWIO; ``mults``: G of (O,) float32; ``bias``: (O,) float32;
    ``act``: one of ``ACTS``, with ``slope`` (O,) float32 for ``"prelu"``.
    Returns (B, H, W, O) int8 equal to ``conv_s8_reference``.  ``packed``:
    the kernels already through ``pack_conv_s8_weights`` (packed here if
    None).  ``tile``: an index into ``TILES``, ``pick_tile``'s choice if
    None.

    CPU tensors run the plain version; CUDA tensors run the kernel, which
    adds one to ``conv_s8.launches`` per launch and to
    ``conv_s8.shapes[(B, H, W, (C_0, ...), O, k, act)]``.  What the kernel
    cannot take raises ``ValueError`` on every device."""
    parts, kernels_q, mults = (_as_groups(parts), _as_groups(kernels_q),
                               _as_groups(mults))
    check_inputs(parts, kernels_q, mults, bias, act, slope)
    b, h, w, _ = parts[0].shape
    k, o = kernels_q[0].shape[0], kernels_q[0].shape[3]
    channels = tuple(x.shape[3] for x in parts)
    check_kernel_limits(channels, o, k)
    dev = parts[0].device
    if dev.type == "cpu":
        return conv_s8_reference(parts, kernels_q, mults, bias, act, slope)
    if dev.type != "cuda":
        raise ValueError(f"conv_s8: unsupported device {dev}")
    g = len(parts)
    if tile is None:
        tile = pick_tile(b, h, w, sum(channels), o, k, g)
    if (not 0 <= tile < len(TILES) or o % TILES[tile][2]
            or (g > 1 and tile not in GROUPED_TILES)):
        raise ValueError(f"conv_s8: no tile {tile} for {g} groups and {o} "
                         f"outputs; the kernel has {TILES}, groups take "
                         f"{GROUPED_TILES}")
    if not (all(x.is_contiguous() for x in parts)
            and all(m.is_contiguous() for m in mults)
            and bias.is_contiguous()
            and (slope is None or slope.is_contiguous())):
        raise ValueError("conv_s8: the kernel takes contiguous tensors")
    c_pads = tuple(c_pad(c) for c in channels)
    packed = (tuple(pack_conv_s8_weights(kq) for kq in kernels_q)
              if packed is None else _as_groups(packed))
    for p, cp in zip(packed, c_pads):
        if (p.dtype != torch.int8 or p.shape != (k * k, o, cp)
                or p.device != dev or not p.is_contiguous()):
            raise ValueError(f"conv_s8: packed weights must be contiguous "
                             f"int8 ({k * k}, {o}, {cp}) on {dev}")
    xs = [x.data_ptr() for x in parts]
    ws = [p.data_ptr() for p in packed]
    # cp.async copies 16-byte chunks of the weights and of inputs whose
    # pixels are whole chunks.
    if any(ptr % 16 for ptr in ws) or any(
            ptr % 16 for ptr, c in zip(xs, channels) if c % 16 == 0):
        raise ValueError("conv_s8: the input and the packed weights must be "
                         "16-byte aligned")
    out = torch.empty((b, h, w, o), dtype=torch.int8, device=dev)
    lib = _library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    args = ((vp * g)(*xs), (vp * g)(*ws),
            (vp * g)(*[m.data_ptr() for m in mults]), (ci * g)(*channels),
            (ci * g)(*c_pads), g, bias.data_ptr(),
            None if slope is None else slope.data_ptr(), out.data_ptr(),
            b, h, w, o, k, ACTS.index(act), tile)
    if dev.index in (None, torch.cuda.current_device()):
        err = lib.conv_s8_launch(*args,
                                 torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.conv_s8_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, "conv_s8", err)
    conv_s8.launches += 1
    conv_s8.shapes[(b, h, w, channels, o, k, act)] += 1
    return out


conv_s8.launches = 0
conv_s8.shapes = collections.Counter()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("conv_s8")
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs, ints = ctypes.POINTER(p), ctypes.POINTER(i)
    lib.conv_s8_launch.argtypes = [ptrs, ptrs, ptrs, ints, ints, i, p, p, p,
                                   i, i, i, i, i, i, i, p]
    lib.conv_s8_launch.restype = i
    return lib
