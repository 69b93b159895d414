"""``torch.library`` custom ops: the port's CUDA kernels and the grouping
fold, as opaque operators that ``torch.export`` can trace.

The kernels' wrappers launch through ``ctypes`` on raw device pointers, and
the grouping fold reads its trip count to the host and loops in Python over
data-dependent indices; neither traces.  Each is registered here as an op of
the ``tpupose`` namespace:

- ``tpupose::blur_nms``, ``tpupose::conv7_s8``, ``tpupose::conv_s8`` and
  ``tpupose::requant_epilogue``: the CUDA implementation calls the wrapper
  (``ops/blur_nms.py``, ``ops/conv7.py``, ``ops/conv_s8.py``,
  ``ops/requant.py``), which launches the hand kernel or raises, and counts
  the launch in its ``launches`` and ``shapes``; the CPU implementation is
  the plain version;
- ``tpupose::group_keypoints``: the fold of ``ops/grouping.py`` with its one
  host read inside the op, on every device (it is not a kernel);
- ``tpupose::greedy_match``: the PAF matcher of ``ops/paf.py``, on every
  device (not a kernel either).  Its K = 32 unrolled steps are ~1,450 of
  the ~1,960 nodes a traced fast-path program has without it, and export,
  save and load times grow with the node count.

Each op's fake implementation gives its output shapes and dtypes, so a
program is traced without running it.  The ops are registered with
``torch.library.Library`` (``define`` + ``impl`` per dispatch key) rather
than ``torch.library.custom_op``, whose Python dispatch layers cost ~3x
the host time per call (24 against 9 us measured on a CPU); an int8
program calls 80 of them per forward.

The functions below are what the pipeline calls.  Live detectors go
straight to the wrappers: op dispatch costs host time, and the int8 forward
is already host-bound.  Inside ``traced_ops()`` (``detectors/portable.py::
portable_programs`` enters it around an export) they route through the
ops, so an exported program holds ``tpupose::*`` calls that dispatch by
device when it runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from tpupose_torch.ops import blur_nms as _bn
from tpupose_torch.ops import conv7 as _c7
from tpupose_torch.ops import conv_s8 as _cs
from tpupose_torch.ops import requant as _rq

_ROUTE = threading.local()
_LIB = torch.library.Library("tpupose", "DEF")
_OPS = torch.ops.tpupose


def tracing() -> bool:
    """True inside ``traced_ops()`` on this thread."""
    return getattr(_ROUTE, "traced", False)


@contextlib.contextmanager
def traced_ops():
    """Route this thread's kernel and fold calls through the ``tpupose::*``
    ops while the block runs (an export traces inside it)."""
    before = tracing()
    _ROUTE.traced = True
    try:
        yield
    finally:
        _ROUTE.traced = before


def _define(schema: str, impls: dict, fake) -> None:
    """Define ``tpupose::<schema>``, register an implementation per
    dispatch key and the fake implementation."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    for key, fn in impls.items():
        _LIB.impl(name, fn, key)
    torch.library.register_fake(f"tpupose::{name}", fake, lib=_LIB)


# ---------------------------------------------------------------------------
# tpupose::blur_nms
# ---------------------------------------------------------------------------

_define(
    "blur_nms(Tensor heatmaps, float sigma, float thresh) -> (Tensor, Tensor)",
    {"CUDA": _bn.blur_nms, "CPU": _bn.blur_nms_reference},
    lambda heatmaps, sigma, thresh: (
        torch.empty_like(heatmaps),
        heatmaps.new_empty(heatmaps.shape, dtype=torch.bool)))


def blur_nms(heatmaps: Tensor, sigma: float, thresh: float
             ) -> Tuple[Tensor, Tensor]:
    """``ops/blur_nms.py::blur_nms``, through ``tpupose::blur_nms`` when
    traced."""
    if tracing():
        return _OPS.blur_nms.default(heatmaps, float(sigma), float(thresh))
    return _bn.blur_nms(heatmaps, sigma, thresh)


# ---------------------------------------------------------------------------
# tpupose::conv7_s8
# ---------------------------------------------------------------------------


def _conv7_s8_cuda(parts, kernels_q, mults, bias, relu, packed):
    return _c7.conv7_s8(parts, kernels_q, mults, bias, relu=relu,
                        packed=packed or None)


def _conv7_s8_cpu(parts, kernels_q, mults, bias, relu, packed):
    return _c7.conv7_s8_reference(parts, kernels_q, mults, bias, relu)


def _conv7_s8_fake(parts, kernels_q, mults, bias, relu, packed):
    b, h, w, _ = parts[0].shape
    return parts[0].new_empty((b, h, w, kernels_q[0].shape[-1]),
                              dtype=torch.int8)


_define("conv7_s8(Tensor[] parts, Tensor[] kernels_q, Tensor[] mults, "
        "Tensor bias, bool relu, Tensor[] packed) -> Tensor",
        {"CUDA": _conv7_s8_cuda, "CPU": _conv7_s8_cpu}, _conv7_s8_fake)


def conv7_s8(parts: Sequence[Tensor], kernels_q: Sequence[Tensor],
             mults: Sequence[Tensor], bias: Tensor, relu: bool = True,
             packed: Optional[Sequence[Tensor]] = None) -> Tensor:
    """``ops/conv7.py::conv7_s8``, through ``tpupose::conv7_s8`` when
    traced (an empty ``packed`` list packs the weights in the wrapper)."""
    if tracing():
        return _OPS.conv7_s8.default(list(parts), list(kernels_q),
                                     list(mults), bias, bool(relu),
                                     list(packed or ()))
    return _c7.conv7_s8(parts, kernels_q, mults, bias, relu=relu,
                        packed=packed)


# ---------------------------------------------------------------------------
# tpupose::conv_s8
# ---------------------------------------------------------------------------


def _conv_s8_cuda(x, kernel_q, mult, bias, relu, packed):
    return _cs.conv_s8(x, kernel_q, mult, bias, relu=relu, packed=packed)


def _conv_s8_cpu(x, kernel_q, mult, bias, relu, packed):
    return _cs.conv_s8_reference(x, kernel_q, mult, bias, relu)


def _conv_s8_fake(x, kernel_q, mult, bias, relu, packed):
    b, h, w, _ = x.shape
    return x.new_empty((b, h, w, kernel_q.shape[-1]), dtype=torch.int8)


_define("conv_s8(Tensor x, Tensor kernel_q, Tensor mult, Tensor bias, "
        "bool relu, Tensor? packed) -> Tensor",
        {"CUDA": _conv_s8_cuda, "CPU": _conv_s8_cpu}, _conv_s8_fake)


def conv_s8(x: Tensor, kernel_q: Tensor, mult: Tensor, bias: Tensor,
            relu: bool = True, packed: Optional[Tensor] = None) -> Tensor:
    """``ops/conv_s8.py::conv_s8``, through ``tpupose::conv_s8`` when
    traced."""
    if tracing():
        return _OPS.conv_s8.default(x, kernel_q, mult, bias, bool(relu),
                                    packed)
    return _cs.conv_s8(x, kernel_q, mult, bias, relu=relu, packed=packed)


# ---------------------------------------------------------------------------
# tpupose::requant_epilogue
# ---------------------------------------------------------------------------

_define("requant_epilogue(Tensor[] accs, Tensor[] mults, Tensor bias, "
        "bool relu, float lo) -> Tensor",
        {"CUDA": _rq.requant_epilogue,
         "CPU": _rq.requant_epilogue_reference},
        lambda accs, mults, bias, relu, lo: accs[0].new_empty(
            accs[0].shape, dtype=torch.int8))


def requant_epilogue(accs: Sequence[Tensor], mults: Sequence[Tensor],
                     bias: Tensor, relu: bool, lo: float = 0.0) -> Tensor:
    """``ops/requant.py::requant_epilogue``, through
    ``tpupose::requant_epilogue`` when traced."""
    if tracing():
        return _OPS.requant_epilogue.default(list(accs), list(mults), bias,
                                             bool(relu), float(lo))
    return _rq.requant_epilogue(accs, mults, bias, relu, lo)


# ---------------------------------------------------------------------------
# tpupose::greedy_match
# ---------------------------------------------------------------------------


def _greedy_match(score, valid, n_a, n_b):
    from tpupose_torch.ops.paf import greedy_match as match

    return tuple(match(score, valid, n_a, n_b))


def _greedy_match_fake(score, valid, n_a, n_b):
    n_limbs, k = score.shape[:2]
    return (score.new_empty((n_limbs, k), dtype=torch.long),
            score.new_empty((n_limbs, k), dtype=torch.long),
            score.new_empty((n_limbs, k)),
            score.new_empty((n_limbs, k), dtype=torch.bool))


_define("greedy_match(Tensor score, Tensor valid, Tensor n_a, Tensor n_b) "
        "-> (Tensor, Tensor, Tensor, Tensor)",
        {"CompositeExplicitAutograd": _greedy_match}, _greedy_match_fake)


def greedy_match(score: Tensor, valid: Tensor, n_a: Tensor, n_b: Tensor):
    """``ops/paf.py::greedy_match``, through ``tpupose::greedy_match`` when
    traced."""
    if tracing():
        return _OPS.greedy_match.default(score, valid, n_a, n_b)
    return _greedy_match(score, valid, n_a, n_b)


# ---------------------------------------------------------------------------
# tpupose::group_keypoints
# ---------------------------------------------------------------------------


def _group_keypoints(a_slot, b_slot, conn_score, conn_valid, peak_score,
                     max_subsets, n_subset_limbs_thresh, subset_score_thresh):
    from tpupose_torch.ops.grouping import fold_connections

    return tuple(fold_connections(
        a_slot, b_slot, conn_score, conn_valid, peak_score, max_subsets,
        n_subset_limbs_thresh, subset_score_thresh))


def _group_keypoints_fake(a_slot, b_slot, conn_score, conn_valid, peak_score,
                          max_subsets, n_subset_limbs_thresh,
                          subset_score_thresh):
    from tpupose_torch.config import NUM_JOINTS

    s = max_subsets
    return (a_slot.new_empty((s, NUM_JOINTS), dtype=torch.long),
            conn_score.new_empty((s,)), conn_score.new_empty((s,)),
            conn_valid.new_empty((s,)),
            a_slot.new_empty((), dtype=torch.long))


_define("group_keypoints(Tensor a_slot, Tensor b_slot, Tensor conn_score, "
        "Tensor conn_valid, Tensor peak_score, int max_subsets, "
        "float n_subset_limbs_thresh, float subset_score_thresh) -> "
        "(Tensor, Tensor, Tensor, Tensor, Tensor)",
        {"CompositeExplicitAutograd": _group_keypoints},
        _group_keypoints_fake)


def group_keypoints(connections, peaks, cfg):
    """``ops/grouping.py::group_keypoints``, through
    ``tpupose::group_keypoints`` when traced."""
    from tpupose_torch.ops.grouping import Subsets, group_keypoints as fold

    if tracing():
        return Subsets(*_OPS.group_keypoints.default(
            connections.a_slot, connections.b_slot, connections.score,
            connections.valid, peaks.score, int(cfg.max_subsets),
            float(cfg.n_subset_limbs_thresh),
            float(cfg.subset_score_thresh)))
    return fold(connections, peaks, cfg)
