"""The w8a8 requantize epilogue: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``tpupose/ops/pallas/requant.py::
requant_epilogue``, whose math is the epilogue of ``tpupose/quant.py::
_qconv``: ``clip(round(max(sum_g acc_g * mult_g + bias, 0)), lo, 127)`` as
int8.  The port adds the activations of BODY_25 (``epilogue_reference``):
none, ReLU or PReLU with a slope per channel.  On the int8 forward's im2col
route (``conv7_impl="im2col"``) every int8 layer that is not a head runs as
im2col + ``torch._int_mm`` and is finished here; on its kernel route the
epilogue is fused into ``ops/conv_s8.py`` and ``ops/conv7.py``.
``epilogue`` and its two forms, ``requant_epilogue`` (the JAX package's
``relu``/``lo``) and ``act_epilogue`` (a layer's activation), route by the
device of their inputs only: CPU tensors take the plain version; CUDA
tensors launch ``tpupose_torch/csrc/requant.cu`` or raise.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence

import torch

from tpupose_torch.ops import _cuda_build

MAX_GROUPS = 4  # REQUANT_MAX_GROUPS in csrc/requant.cu


def scaled_sum(accs: Sequence[torch.Tensor], mults: Sequence[torch.Tensor],
               bias: torch.Tensor) -> torch.Tensor:
    """``acc_0 * mult_0 + acc_1 * mult_1 + ... + bias`` in float32, in that
    order, each operation rounded on its own (the f32 heads' output and the
    first half of the epilogue)."""
    y = None
    for acc, mult in zip(accs, mults):
        part = acc.float() * mult
        y = part if y is None else y + part
    return y + bias


ACTS = ("none", "relu", "prelu")   # activation codes 0, 1, 2 of the kernels


def epilogue_reference(accs: Sequence[torch.Tensor],
                       mults: Sequence[torch.Tensor], bias: torch.Tensor,
                       act: str, lo: float,
                       slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version.  accs: G int32 (..., C) tensors of one shape;
    mults: G (C,) float32; bias: (C,) float32; slope: (C,) float32, PReLU
    only -> (..., C) int8: ``y = scaled_sum(...)``, then ``"relu"``:
    ``max(y, 0)``; ``"prelu"``: ``y < 0 ? y * slope_c : y`` (one float32
    product); ``"none"``: ``y``; then ``clip(round(y), lo, 127)``."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; one of {ACTS}")
    y = scaled_sum(accs, mults, bias)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "prelu":
        y = torch.where(y < 0, y * slope, y)
    return torch.clamp(torch.round(y), lo, 127.0).to(torch.int8)


def _act_lo(act: str) -> float:
    """A conv layer's store: ReLU outputs occupy [0, 127], signed ones
    (PReLU, none) [-127, 127]."""
    return 0.0 if act == "relu" else -127.0


def requant_epilogue_reference(accs: Sequence[torch.Tensor],
                               mults: Sequence[torch.Tensor],
                               bias: torch.Tensor, relu: bool,
                               lo: float = 0.0) -> torch.Tensor:
    """``clip(round(max(sum_g acc_g * mult_g + bias, 0)), lo, 127)``, the
    max only with ``relu``: the JAX package's epilogue."""
    return epilogue_reference(accs, mults, bias, "relu" if relu else "none",
                              lo)


def act_epilogue_reference(accs: Sequence[torch.Tensor],
                           mults: Sequence[torch.Tensor], bias: torch.Tensor,
                           act: str, slope: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The epilogue of a conv layer with activation ``act``: ``"relu"``
    stored in [0, 127], ``"prelu"`` and ``"none"`` in [-127, 127]."""
    return epilogue_reference(accs, mults, bias, act, _act_lo(act), slope)


def epilogue(accs: Sequence[torch.Tensor], mults: Sequence[torch.Tensor],
             bias: torch.Tensor, act: str, lo: float,
             slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The semantics of ``epilogue_reference``.  CPU tensors run the plain
    version; CUDA tensors run ``csrc/requant.cu``, which adds one to
    ``requant_epilogue.launches`` per launch and to
    ``requant_epilogue.shapes[(shape, G, act, lo)]``."""
    dev = accs[0].device
    if dev.type == "cpu":
        return epilogue_reference(accs, mults, bias, act, lo, slope)
    if dev.type != "cuda":
        raise ValueError(f"requant_epilogue: unsupported device {dev}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; one of {ACTS}")
    shape = tuple(accs[0].shape)
    c = shape[-1]
    if not 1 <= len(accs) <= MAX_GROUPS or len(mults) != len(accs):
        raise ValueError(f"requant_epilogue: {len(accs)} accumulators and "
                         f"{len(mults)} mults; 1 to {MAX_GROUPS} groups")
    for acc in accs:
        if (acc.dtype != torch.int32 or tuple(acc.shape) != shape
                or acc.device != dev or not acc.is_contiguous()):
            raise ValueError(
                f"requant_epilogue: accumulators must be contiguous int32 "
                f"{shape} on {dev}, got {acc.dtype} {tuple(acc.shape)} "
                f"on {acc.device}")
    vectors = (*mults, bias) + ((slope,) if act == "prelu" else ())
    for t in vectors:
        if (t is None or t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"requant_epilogue: mults, bias and a PReLU "
                             f"slope must be contiguous float32 ({c},) on "
                             f"{dev}")
    n = accs[0].numel()
    if n >= 2**31:
        raise ValueError(f"requant_epilogue: {n} elements exceed int32")
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    lib = _library()
    g = len(accs)
    vp = ctypes.c_void_p
    args = ((vp * g)(*[a.data_ptr() for a in accs]),
            (vp * g)(*[m.data_ptr() for m in mults]), g, bias.data_ptr(),
            slope.data_ptr() if act == "prelu" else None, out.data_ptr(), n,
            c, ACTS.index(act), float(lo))
    with torch.cuda.device(dev):
        err = lib.requant_launch(*args,
                                 torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, "requant", err)
    requant_epilogue.launches += 1
    requant_epilogue.shapes[(shape, g, act, float(lo))] += 1
    return out


def requant_epilogue(accs: Sequence[torch.Tensor],
                     mults: Sequence[torch.Tensor], bias: torch.Tensor,
                     relu: bool, lo: float = 0.0) -> torch.Tensor:
    """The semantics of ``requant_epilogue_reference``, routed as
    ``epilogue``; its ``launches`` and ``shapes`` count every launch of
    the kernel."""
    return epilogue(accs, mults, bias, "relu" if relu else "none", lo)


def act_epilogue(accs: Sequence[torch.Tensor], mults: Sequence[torch.Tensor],
                 bias: torch.Tensor, act: str,
                 slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The semantics of ``act_epilogue_reference``, routed as
    ``epilogue``."""
    return epilogue(accs, mults, bias, act, _act_lo(act), slope)


requant_epilogue.launches = 0
requant_epilogue.shapes = collections.Counter()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("requant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.requant_launch.argtypes = [ctypes.POINTER(p), ctypes.POINTER(p), i,
                                   p, p, p, i, i, i, ctypes.c_float, p]
    lib.requant_launch.restype = i
    return lib
