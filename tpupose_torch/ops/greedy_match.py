"""Greedy 1:1 limb matching: the CUDA kernel's wrapper.

Replaces the JAX package's device loop ``tpupose/ops/paf.py::greedy_match``
(a ``lax.while_loop`` of masked argmaxes, ``vmap``ped over limbs and
frames; no Pallas kernel).  ``greedy_match`` routes by the device of its
input only: a CPU tensor takes the plain version, ``ops/paf.py::
greedy_match``; a CUDA tensor launches ``tpupose_torch/csrc/
greedy_match.cu`` (one warp per frame and limb) or raises.  There is no
fallback, and no host sync: the kernel loops on the device.

The kernel is built at its first launch by ``ops/_cuda_build.py``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from tpupose_torch.ops import _cuda_build

MAX_K = 128  # the kernel keeps a row's and a column's masks in 4 words


def greedy_match(score: torch.Tensor, valid: torch.Tensor,
                 n_a: torch.Tensor, n_b: torch.Tensor):
    """score/valid: (..., K, K) float32 and bool, rows the joint-a
    candidates; n_a, n_b: (...) integer counts.  Returns (a_slot, b_slot,
    score, valid), each (..., K): int64 slots (-1 unused), float32 scores,
    bool, accepted connections first in greedy order.  The semantics of
    ``ops/paf.py::greedy_match``; CPU tensors run it, CUDA tensors run the
    kernel, which adds one to ``greedy_match.launches`` per launch and to
    ``greedy_match.shapes[(*lead, K)]``."""
    dev = score.device
    if dev.type == "cpu":
        # imported here: ops/paf.py imports ops/library.py, which imports
        # this module
        from tpupose_torch.ops.paf import greedy_match as reference

        return reference(score, valid, n_a, n_b)
    if dev.type != "cuda":
        raise ValueError(f"greedy_match: unsupported device {dev}")
    k = score.shape[-1]
    lead = tuple(score.shape[:-2])
    if (score.dim() < 2 or score.shape[-2] != k
            or score.dtype != torch.float32):
        raise ValueError(f"greedy_match: expected (..., K, K) float32 "
                         f"scores, got {score.dtype} {tuple(score.shape)}")
    if valid.dtype != torch.bool or valid.shape != score.shape:
        raise ValueError(f"greedy_match: validity must be bool "
                         f"{tuple(score.shape)}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    for name, n in (("n_a", n_a), ("n_b", n_b)):
        if (tuple(n.shape) != lead or n.dtype.is_floating_point
                or n.dtype == torch.bool):
            raise ValueError(f"greedy_match: {name} must be integer "
                             f"{lead}, got {n.dtype} {tuple(n.shape)}")
    for t in (valid, n_a, n_b):
        if t.device != dev:
            raise ValueError(f"greedy_match: inputs on {t.device} and {dev}")
    if k > MAX_K:
        raise ValueError(f"greedy_match: K = {k} candidates a side; the "
                         f"kernel takes K <= {MAX_K}")
    with torch.cuda.device(dev):
        out = _launch(_library(), score, valid, n_a, n_b,
                      torch.cuda.current_stream().cuda_stream)
    greedy_match.launches += 1
    greedy_match.shapes[(*lead, k)] += 1
    return out


greedy_match.launches = 0
greedy_match.shapes = collections.Counter()


def _launch(lib, score, valid, n_a, n_b, stream):
    """Allocate the outputs beside ``score`` and launch on ``lib`` (the
    built library; the tests pass a host build of the same source), on
    ``stream``."""
    lead, k = tuple(score.shape[:-2]), score.shape[-1]
    dev = score.device
    out_a = torch.empty((*lead, k), dtype=torch.int64, device=dev)
    out_b = torch.empty_like(out_a)
    out_s = torch.empty((*lead, k), dtype=torch.float32, device=dev)
    out_v = torch.empty((*lead, k), dtype=torch.bool, device=dev)
    rows = math.prod(lead)
    if rows == 0 or k == 0:
        return out_a, out_b, out_s, out_v
    score, valid = score.contiguous(), valid.contiguous()
    n_a = n_a.to(torch.int64).contiguous()
    n_b = n_b.to(torch.int64).contiguous()
    err = lib.greedy_match_launch(
        score.data_ptr(), valid.data_ptr(), n_a.data_ptr(), n_b.data_ptr(),
        out_a.data_ptr(), out_b.data_ptr(), out_s.data_ptr(),
        out_v.data_ptr(), rows, k, stream)
    _cuda_build.check(lib, "greedy_match", err)
    return out_a, out_b, out_s, out_v


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``lib``'s launch function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.greedy_match_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
    lib.greedy_match_launch.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_cuda_build.load("greedy_match"))
