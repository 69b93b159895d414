"""The grouping fold: the CUDA kernel's wrapper.

Replaces the JAX package's device loop ``tpupose/ops/grouping.py::
group_keypoints`` (a ``lax.while_loop`` over the compacted valid
connections, ``vmap``ped over frames; no Pallas kernel).  ``group_fold``
routes by the device of its inputs only: CPU tensors take the plain
version, ``ops/grouping.py::fold_connections`` (which reads its trip count
to the host); CUDA tensors launch ``tpupose_torch/csrc/group_fold.cu``
(one warp per frame) or raise.  There is no fallback, and no host sync:
the kernel walks the connections on the device.

The kernel is built at its first launch by ``ops/_cuda_build.py``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.topology import COCO18, Topology

MAX_LIMBS = 64  # GROUP_FOLD_MAX_LIMBS in csrc/group_fold.cu
MAX_SMEM_BYTES = 227 * 1024
MAX_SUBSETS = 1024  # a lane keeps its rows' active flags in one word


def smem_bytes(n_limbs: int, k: int, s: int, kp: int,
               num_joints: int = COCO18.num_joints) -> int:
    """Shared memory of one block (``smem_bytes`` in ``csrc/
    group_fold.cu``): the (J, KP) peak scores, the table by column at
    stride ``S | 1``, score and count, per connection its flag byte, its
    place in the listed order and its six staged fields, and 32 words of
    slack."""
    lk = n_limbs * k
    return 4 * ((num_joints * kp + 3) // 4 * 4 + num_joints * (s | 1)
                + 2 * s + (lk + 3) // 4 + 7 * lk + 32)


def group_fold(a_slot: torch.Tensor, b_slot: torch.Tensor,
               conn_score: torch.Tensor, conn_valid: torch.Tensor,
               peak_score: torch.Tensor, max_subsets: int,
               n_subset_limbs_thresh, subset_score_thresh,
               topology: Topology = COCO18):
    """Connections' (..., L, K) int64 slots, float32 scores and bool
    validity, the peaks' (..., J, K) float32 scores -> the ``Subsets``
    fields: joint_slot (..., S, J) int64, score and count (..., S) float32,
    valid (..., S) bool, spawns_suppressed (...) int64, with S =
    ``max_subsets``.  Limb ``l`` joins parts ``topology.limbs[l]``; J is
    ``topology.num_joints``.  The semantics of ``ops/grouping.py::
    fold_connections``; CPU tensors run it, CUDA tensors run the kernel,
    which adds one to ``group_fold.launches`` per launch and to
    ``group_fold.shapes[(*lead, L, K, S, J)]``.  The slots of valid
    connections must lie in ``[0, K)``."""
    dev = a_slot.device
    if dev.type == "cpu":
        # imported here: ops/grouping.py imports ops/paf.py, which imports
        # ops/library.py, which imports this module
        from tpupose_torch.ops.grouping import fold_connections

        return tuple(fold_connections(
            a_slot, b_slot, conn_score, conn_valid, peak_score, max_subsets,
            n_subset_limbs_thresh, subset_score_thresh, topology))
    if dev.type != "cuda":
        raise ValueError(f"group_fold: unsupported device {dev}")
    shape = tuple(a_slot.shape)
    if len(shape) < 2:
        raise ValueError(f"group_fold: expected (..., L, K) connections, "
                         f"got {shape}")
    lead, (n_limbs, k) = shape[:-2], shape[-2:]
    for name, t, dtype in (("b_slot", b_slot, torch.int64),
                           ("a_slot", a_slot, torch.int64),
                           ("conn_score", conn_score, torch.float32),
                           ("conn_valid", conn_valid, torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"group_fold: {name} must be {dtype} {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if (peak_score.dim() != len(lead) + 2
            or tuple(peak_score.shape[:-2]) != lead
            or peak_score.shape[-2] != topology.num_joints
            or peak_score.dtype != torch.float32
            or peak_score.device != dev):
        raise ValueError(f"group_fold: peak scores must be float32 "
                         f"{(*lead, topology.num_joints, 'K')} on {dev}, got "
                         f"{peak_score.dtype} {tuple(peak_score.shape)}")
    if not 0 < n_limbs <= min(MAX_LIMBS, topology.num_limbs):
        raise ValueError(f"group_fold: {n_limbs} limbs; the topology has "
                         f"{topology.num_limbs}")
    s = int(max_subsets)
    smem = smem_bytes(n_limbs, k, s, peak_score.shape[-1],
                      topology.num_joints)
    if not 0 < s <= MAX_SUBSETS:
        raise ValueError(f"group_fold: max_subsets {s}; the kernel takes "
                         f"1 to {MAX_SUBSETS}")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"group_fold: max_subsets {s} with {n_limbs} x {k} "
                         f"connections needs {smem} bytes of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")
    with torch.cuda.device(dev):
        out = _launch(_library(), *_limbs(n_limbs, topology), a_slot, b_slot,
                      conn_score, conn_valid, peak_score, s,
                      n_subset_limbs_thresh, subset_score_thresh,
                      torch.cuda.current_stream().cuda_stream)
    group_fold.launches += 1
    group_fold.shapes[(*lead, n_limbs, k, s, topology.num_joints)] += 1
    return out


group_fold.launches = 0
group_fold.shapes = collections.Counter()


def _launch(lib, limbs_from, limbs_to, spawns, a_slot, b_slot, conn_score,
            conn_valid, peak_score, max_subsets, n_subset_limbs_thresh,
            subset_score_thresh, stream):
    """Allocate the outputs beside ``a_slot`` and launch on ``lib`` (the
    built library; the tests pass a host build of the same source), on
    ``stream``; ``limbs_*`` and ``spawns``: ``_limbs``' ctypes arrays.  J
    is the peak table's."""
    lead, (n_limbs, k) = tuple(a_slot.shape[:-2]), a_slot.shape[-2:]
    dev, s = a_slot.device, max_subsets
    n_joints = peak_score.shape[-2]
    out_slot = torch.empty((*lead, s, n_joints), dtype=torch.int64,
                           device=dev)
    out_score = torch.empty((*lead, s), dtype=torch.float32, device=dev)
    out_count = torch.empty_like(out_score)
    out_valid = torch.empty((*lead, s), dtype=torch.bool, device=dev)
    out_suppressed = torch.empty(lead, dtype=torch.int64, device=dev)
    out = (out_slot, out_score, out_count, out_valid, out_suppressed)
    frames = math.prod(lead)
    if frames == 0:
        return out
    args = [t.contiguous() for t in (a_slot, b_slot, conn_score, conn_valid,
                                     peak_score)]
    err = lib.group_fold_launch(
        *[t.data_ptr() for t in args], limbs_from, limbs_to, spawns, frames,
        n_limbs, k, n_joints, peak_score.shape[-1], s,
        float(n_subset_limbs_thresh), float(subset_score_thresh),
        *[t.data_ptr() for t in out], stream)
    _cuda_build.check(lib, "group_fold", err)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type ``lib``'s launch function."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(ctypes.c_int)
    lib.group_fold_launch.argtypes = [p, p, p, p, p, ints, ints, ints,
                                      i, i, i, i, i, i, f, f, p, p, p, p, p,
                                      p]
    lib.group_fold_launch.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_cuda_build.load("group_fold"))


@functools.lru_cache(maxsize=8)
def _limbs(n_limbs: int, topology: Topology = COCO18):
    """The first ``n_limbs`` pairs' endpoints and spawn flags of
    ``topology`` as ctypes int arrays (the launch copies them)."""
    row = ctypes.c_int * n_limbs
    return (row(*[int(j) for j in topology.limbs_from[:n_limbs]]),
            row(*[int(j) for j in topology.limbs_to[:n_limbs]]),
            row(*topology.spawns[:n_limbs]))
