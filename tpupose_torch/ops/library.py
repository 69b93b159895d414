"""``torch.library`` custom ops: the port's CUDA kernels, as opaque
operators that ``torch.export`` can trace.

The kernels' wrappers launch through ``ctypes`` on raw device pointers, and
the plain grouping fold reads its trip count to the host and loops in
Python over data-dependent indices; neither traces.  Each is registered
here as an op of the ``tpupose`` namespace, whose CUDA implementation calls
the wrapper, which launches the hand kernel or raises and counts the launch
in its ``launches`` and ``shapes``, and whose CPU implementation is the
plain version:

- ``tpupose::blur_nms``, ``tpupose::conv7_s8``, ``tpupose::conv_s8``,
  ``tpupose::requant_epilogue`` and ``tpupose::act_epilogue``:
  ``ops/blur_nms.py``, ``ops/conv7.py``, ``ops/conv_s8.py``,
  ``ops/requant.py`` (the last two one kernel);
- ``tpupose::greedy_match``: ``ops/greedy_match.py`` (plain version
  ``ops/paf.py::greedy_match``), on (..., L, K, K) candidates, a frame
  axis or none.  As an op, the plain version's K = 32 unrolled steps
  (~1,450 nodes) stay out of a traced CPU program, and export, save and
  load times grow with the node count;
- ``tpupose::group_keypoints``: ``ops/group_fold.py`` (plain version
  ``ops/grouping.py::fold_connections``), on (..., L, K) connections;
- ``tpupose::crop_tails``: ``ops/crop_tail.py``, every crop's keypoint
  tail of a face or hand request, the targets as a flat ``[th, tw, ...]``
  list.

Each op's fake implementation gives its output shapes and dtypes, so a
program is traced without running it.  The ops are registered with
``torch.library.Library`` (``define`` + ``impl`` per dispatch key) rather
than ``torch.library.custom_op``, whose Python dispatch layers cost ~3x
the host time per call (24 against 9 us measured on a CPU); an int8
program calls 80 of them per forward.

The functions below are what the pipeline calls.  Live detectors go
straight to the wrappers: op dispatch costs host time, and the int8 forward
is already host-bound.  Inside ``traced_ops()`` (``serving.py`` enters it
around an export) they route through the ops, so an exported program
holds ``tpupose::*`` calls that dispatch by device when it runs.
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
from tpupose_torch.ops import crop_tail as _ct
from tpupose_torch.ops import greedy_match as _gm
from tpupose_torch.ops import group_fold as _gf
from tpupose_torch.ops import requant as _rq
from tpupose_torch.topology import COCO18, Topology, from_tables

_ROUTE = threading.local()
_LIB = torch.library.Library("tpupose", "DEF")
_OPS = torch.ops.tpupose


def tracing() -> bool:
    """True inside ``traced_ops()`` on this thread."""
    return getattr(_ROUTE, "traced", False)


@contextlib.contextmanager
def traced_ops():
    """Route this thread's kernel calls through the ``tpupose::*`` ops
    while the block runs (an export traces inside it)."""
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


def _conv_s8_cuda(parts, kernels_q, mults, bias, act, slope, packed):
    return _cs.conv_s8(parts, kernels_q, mults, bias, act=act, slope=slope,
                       packed=packed or None)


def _conv_s8_cpu(parts, kernels_q, mults, bias, act, slope, packed):
    return _cs.conv_s8_reference(parts, kernels_q, mults, bias, act, slope)


def _conv_s8_fake(parts, kernels_q, mults, bias, act, slope, packed):
    b, h, w, _ = parts[0].shape
    return parts[0].new_empty((b, h, w, kernels_q[0].shape[-1]),
                              dtype=torch.int8)


_define("conv_s8(Tensor[] parts, Tensor[] kernels_q, Tensor[] mults, "
        "Tensor bias, str act, Tensor? slope, Tensor[] packed) -> Tensor",
        {"CUDA": _conv_s8_cuda, "CPU": _conv_s8_cpu}, _conv_s8_fake)


def conv_s8(parts, kernels_q, mults, bias: Tensor, act: str = "relu",
            slope: Optional[Tensor] = None, packed=None) -> Tensor:
    """``ops/conv_s8.py::conv_s8`` (a tensor or a sequence of groups each
    for ``parts``, ``kernels_q``, ``mults``, ``packed``), through
    ``tpupose::conv_s8`` when traced (an empty ``packed`` list packs the
    weights in the wrapper)."""
    if tracing():
        groups = _cs._as_groups
        return _OPS.conv_s8.default(
            list(groups(parts)), list(groups(kernels_q)), list(groups(mults)),
            bias, act, slope, [] if packed is None else list(groups(packed)))
    return _cs.conv_s8(parts, kernels_q, mults, bias, act=act, slope=slope,
                       packed=packed)


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
# tpupose::act_epilogue
# ---------------------------------------------------------------------------

_define("act_epilogue(Tensor[] accs, Tensor[] mults, Tensor bias, str act, "
        "Tensor? slope) -> Tensor",
        {"CUDA": _rq.act_epilogue, "CPU": _rq.act_epilogue_reference},
        lambda accs, mults, bias, act, slope: accs[0].new_empty(
            accs[0].shape, dtype=torch.int8))


def act_epilogue(accs: Sequence[Tensor], mults: Sequence[Tensor],
                 bias: Tensor, act: str,
                 slope: Optional[Tensor] = None) -> Tensor:
    """``ops/requant.py::act_epilogue``, through ``tpupose::act_epilogue``
    when traced."""
    if tracing():
        return _OPS.act_epilogue.default(list(accs), list(mults), bias, act,
                                         slope)
    return _rq.act_epilogue(accs, mults, bias, act, slope)


# ---------------------------------------------------------------------------
# tpupose::greedy_match
# ---------------------------------------------------------------------------


def _greedy_match_fake(score, valid, n_a, n_b):
    shape = score.shape[:-1]
    return (score.new_empty(shape, dtype=torch.long),
            score.new_empty(shape, dtype=torch.long),
            score.new_empty(shape),
            score.new_empty(shape, dtype=torch.bool))


_define("greedy_match(Tensor score, Tensor valid, Tensor n_a, Tensor n_b) "
        "-> (Tensor, Tensor, Tensor, Tensor)",
        {"CUDA": _gm.greedy_match, "CPU": _gm.greedy_match},
        _greedy_match_fake)


def greedy_match(score: Tensor, valid: Tensor, n_a: Tensor, n_b: Tensor):
    """``ops/greedy_match.py::greedy_match``, through
    ``tpupose::greedy_match`` when traced."""
    if tracing():
        return _OPS.greedy_match.default(score, valid, n_a, n_b)
    return _gm.greedy_match(score, valid, n_a, n_b)


# ---------------------------------------------------------------------------
# tpupose::group_keypoints
# ---------------------------------------------------------------------------


def _group_keypoints_fake(a_slot, b_slot, conn_score, conn_valid, peak_score,
                          max_subsets, n_subset_limbs_thresh,
                          subset_score_thresh, limbs_from, limbs_to, spawns):
    lead = a_slot.shape[:-2]
    return (a_slot.new_empty((*lead, max_subsets, peak_score.shape[-2]),
                             dtype=torch.long),
            conn_score.new_empty((*lead, max_subsets)),
            conn_score.new_empty((*lead, max_subsets)),
            conn_valid.new_empty((*lead, max_subsets)),
            a_slot.new_empty(lead, dtype=torch.long))


def _group_keypoints_impl(a_slot, b_slot, conn_score, conn_valid, peak_score,
                          max_subsets, n_subset_limbs_thresh,
                          subset_score_thresh, limbs_from, limbs_to, spawns):
    topology = from_tables(peak_score.shape[-2], limbs_from, limbs_to,
                           spawns)
    return _gf.group_fold(a_slot, b_slot, conn_score, conn_valid, peak_score,
                          max_subsets, n_subset_limbs_thresh,
                          subset_score_thresh, topology)


_define("group_keypoints(Tensor a_slot, Tensor b_slot, Tensor conn_score, "
        "Tensor conn_valid, Tensor peak_score, int max_subsets, "
        "float n_subset_limbs_thresh, float subset_score_thresh, "
        "int[] limbs_from, int[] limbs_to, int[] spawns) -> "
        "(Tensor, Tensor, Tensor, Tensor, Tensor)",
        {"CUDA": _group_keypoints_impl, "CPU": _group_keypoints_impl},
        _group_keypoints_fake)


def group_keypoints(connections, peaks, cfg, topology: Topology = COCO18):
    """The fold of ``ops/group_fold.py`` over ``topology``'s pairs (the
    kernel on CUDA tensors, the plain ``ops/grouping.py::fold_connections``
    on CPU ones), through ``tpupose::group_keypoints`` when traced, which
    carries the pairs as integer tables."""
    from tpupose_torch.ops.grouping import Subsets

    args = (connections.a_slot, connections.b_slot, connections.score,
            connections.valid, peaks.score, int(cfg.max_subsets),
            float(cfg.n_subset_limbs_thresh), float(cfg.subset_score_thresh))
    if tracing():
        return Subsets(*_OPS.group_keypoints.default(
            *args, [int(j) for j in topology.limbs_from],
            [int(j) for j in topology.limbs_to], list(topology.spawns)))
    return Subsets(*_gf.group_fold(*args, topology))


# ---------------------------------------------------------------------------
# tpupose::crop_tails
# ---------------------------------------------------------------------------


def _crop_tails_impl(maps, targets, flips, sigma, thresh):
    # a traced program drops a .contiguous() of its contiguous example
    # input, and is then fed rows of another program's strided output
    return _ct.crop_tails(maps.contiguous(),
                          list(zip(targets[::2], targets[1::2])), flips,
                          sigma, thresh)


_define("crop_tails(Tensor maps, int[] targets, bool[] flips, float sigma, "
        "float thresh) -> Tensor",
        {"CUDA": _crop_tails_impl, "CPU": _crop_tails_impl},
        lambda maps, targets, flips, sigma, thresh: maps.new_empty(
            (maps.shape[0], 4, maps.shape[-1] - 1)))


def crop_tails(maps: Tensor, targets: Sequence[Tuple[int, int]],
               flips: Sequence[bool], sigma: float, thresh: float) -> Tensor:
    """``ops/crop_tail.py::crop_tails``, through ``tpupose::crop_tails``
    when traced."""
    if tracing():
        return _OPS.crop_tails.default(
            maps, [int(v) for hw in targets for v in hw],
            [bool(f) for f in flips], float(sigma), float(thresh))
    return _ct.crop_tails(maps, targets, flips, sigma, thresh)
