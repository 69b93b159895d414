"""The port's postprocess as the JAX package runs it on the device: batched
over frames, with greedy matching and the grouping fold as hand CUDA
kernels (``csrc/greedy_match.cu``, ``csrc/group_fold.cu``), on the CPU.

- The batched plain postprocess of three frames against JAX's
  ``jax.vmap(postprocess_pose)`` (the body of ``detect_batch``'s program),
  field by field; B = 1 slices of the batch against single frames.
- The batched plain matcher and fold against JAX frame by frame, on
  planted tables: exact ties, tables with nothing valid, ``n_a = 0``, a
  full limb, merges, two-subset fills, connections that match three
  subsets, the non-spawning limbs and a saturated table.
- The two kernels' own sources, compiled with g++ through a small CUDA
  shim (as ``tests/test_torch_blur_nms_host.py`` does for blur_nms: each
  block's threads are ``std::thread``s sharing a ``std::barrier`` for
  ``__syncthreads`` and a buffer for the shared memory), launched through
  the wrappers' own ``_launch`` and held bit for bit against the plain
  versions on the same planted cases.  The card's compiler and hardware
  are checked by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
- The ``tpupose::`` ops at batched shapes on the CPU and their fake
  implementations, and a CPU ``torch.export`` of the fast B = 2 program
  equal to the live detector.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import (LIMBS_FROM, LIMBS_TO, NUM_JOINTS, NUM_LIMBS,
                            InferenceConfig)
from tpupose.ops import grouping as jgroup
from tpupose.ops import paf as jpaf
from tpupose.ops import peaks as jpeaks
from tpupose.ops import postprocess as jpost
from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops import greedy_match as tgm
from tpupose_torch.ops import group_fold as tgf
from tpupose_torch.ops import grouping as tgroup
from tpupose_torch.ops import paf as tpaf
from tpupose_torch.ops import postprocess as tpost
from tpupose_torch.topology import BODY25, COCO18

from postprocess_cases import (FOLD_CASE_NAMES, FOLD_CASES, FOLD_SLOTS,
                               MATCH_CASES, WIDE_SLOTS, crowd_tables,
                               fold_steps, fold_tables, match_tables)
from test_postprocess import _render_scene

CFG = InferenceConfig(max_peaks_per_joint=8, max_subsets=32)
HW = (64, 88)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --------------------------------------------------------- planted tables


def _match_case(name, rng, frames=3, k=8):
    return match_tables(rng, name, (frames, NUM_LIMBS), k)


def _fold_case(seed, frames=3):
    return fold_tables(np.random.RandomState(seed), (frames,))


def _fold_cfg(max_subsets):
    return InferenceConfig(max_peaks_per_joint=FOLD_SLOTS,
                           max_subsets=max_subsets, n_subset_limbs_thresh=2,
                           subset_score_thresh=0.3)


def test_planted_fold_cases_hit_every_case():
    """The fold's planted tables take every branch, and the small table
    saturates."""
    seen = set()
    for seed, _ in FOLD_CASES:
        a, b, _, valid, _ = _fold_case(seed)
        for f in range(a.shape[0]):
            seen.update(fold_steps(a[f], b[f], valid[f]))
    assert seen == set(range(len(FOLD_CASE_NAMES)))
    a, b, s, v, p = (_t(x) for x in _fold_case(0))
    sub = tgroup.fold_connections(a, b, s, v, p, 4, 2, 0.3)
    assert int(sub.spawns_suppressed.sum()) > 0


# ------------------------------------------ plain versions against JAX


@pytest.mark.parametrize("name", MATCH_CASES)
def test_batched_greedy_match_matches_jax_per_frame(name):
    k = 32 if name == "full_limb" else 8
    score, valid, n_a, n_b = _match_case(name, np.random.RandomState(1), k=k)
    got = tpaf.greedy_match(_t(score), _t(valid), _t(n_a), _t(n_b))
    assert tuple(got[0].shape) == (3, NUM_LIMBS, k)
    # JAX's per-limb matcher, vmapped over limbs and frames as
    # detect_batch's program runs it
    ref = jax.jit(jax.vmap(jax.vmap(jpaf.greedy_match)))(
        jnp.asarray(score), jnp.asarray(valid), jnp.asarray(n_a, jnp.int32),
        jnp.asarray(n_b, jnp.int32))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if name == "full_limb":
        assert bool(got[3].all())


@pytest.mark.parametrize("seed,cap", FOLD_CASES)
def test_batched_fold_matches_jax_per_frame(seed, cap):
    a, b, s, v, p = _fold_case(seed)
    cfg = _fold_cfg(cap)
    got = tgroup.fold_connections(*(_t(x) for x in (a, b, s, v, p)), cap,
                                  cfg.n_subset_limbs_thresh,
                                  cfg.subset_score_thresh)

    def fold(a, b, s, v, p):
        peaks = jpeaks.Peaks(x=jnp.zeros_like(p), y=jnp.zeros_like(p),
                             score=p, valid=jnp.ones(p.shape, bool))
        return jgroup.group_keypoints(jpaf.Connections(a, b, s, v), peaks,
                                      cfg)

    ref = jax.jit(jax.vmap(fold))(*(jnp.asarray(x) for x in (a, b, s, v, p)))
    for name in ("joint_slot", "valid", "spawns_suppressed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # the same float32 sums in the same order, but XLA may contract or
    # reassociate on the CPU: 1 ulp of values below 64
    for name in ("score", "count"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_crowd_fold_matches_jax():
    """The crowd table (32 people, every limb: 608 steps a frame) through
    the port's plain fold and JAX's ``group_keypoints`` (jitted, vmapped
    over two frames) at the default config, field by field."""
    cfg = InferenceConfig()
    a, b, s, v, p = crowd_tables(np.random.RandomState(9), (2,))
    got = tgroup.fold_connections(*(_t(x) for x in (a, b, s, v, p)),
                                  cfg.max_subsets, cfg.n_subset_limbs_thresh,
                                  cfg.subset_score_thresh)

    def fold(a, b, s, v, p):
        peaks = jpeaks.Peaks(x=jnp.zeros_like(p), y=jnp.zeros_like(p),
                             score=p, valid=jnp.ones(p.shape, bool))
        return jgroup.group_keypoints(jpaf.Connections(a, b, s, v), peaks,
                                      cfg)

    ref = jax.jit(jax.vmap(fold))(*(jnp.asarray(x) for x in (a, b, s, v, p)))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.valid.sum()) == 2 * 32
    assert (got.joint_slot[:, :32] == torch.arange(32)[:, None]).all()


def _scenes(seeds=(3, 4, 5), people=(2, 3, 1)):
    pafs, hms = zip(*(_render_scene(np.random.RandomState(seed), n_people=n,
                                    hw=HW)
                      for seed, n in zip(seeds, people)))
    return np.stack(pafs), np.stack(hms)


def test_batched_postprocess_matches_jax_vmap():
    """Three frames in one call against ``detect_batch``'s body,
    ``jax.vmap(postprocess_pose)``: integer and bool fields and the pose
    tables equal, scores within 2e-6."""
    pafs, hms = _scenes()
    img_len = HW[1]
    ref = jax.jit(jax.vmap(lambda p, h: jpost.postprocess_pose(
        p, h, jnp.float32(img_len), CFG, use_pallas=False)))(
            jnp.asarray(pafs), jnp.asarray(hms))
    got = tpost.postprocess_pose(_t(pafs), _t(hms), img_len, CFG)
    assert tuple(got.poses.shape) == (3, CFG.max_subsets, NUM_JOINTS, 3)
    for name in ("poses", "valid", "num_peaks", "peaks_dropped",
                 "spawns_suppressed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=0, atol=2e-6)
    assert bool(got.valid.any(dim=1).all())


def test_batch_slices_equal_single_frames():
    """Frame i of a B = 3 call equals the frame alone (B = 1 of the same
    code), in the maps' layout and in the PAF-row layout."""
    pafs, hms = _scenes()
    img_len = HW[1]
    batched = tpost.postprocess_pose(_t(pafs), _t(hms), img_len, CFG)
    rows = _t(pafs).reshape(3, NUM_LIMBS, 2, -1).transpose(-1, -2)
    from_rows = tpost.postprocess_pose_from_rows(rows, _t(hms), HW, img_len,
                                                 CFG)
    for i in range(3):
        single = tpost.postprocess_pose(_t(pafs[i]), _t(hms[i]), img_len,
                                        CFG)
        one = tpost.postprocess_pose(_t(pafs[i:i + 1]), _t(hms[i:i + 1]),
                                     img_len, CFG)
        for name, s, b, r, o in zip(single._fields, single, batched,
                                    from_rows, one):
            assert torch.equal(b[i], s), (i, name)
            assert torch.equal(r[i], s), (i, name)
            assert torch.equal(o[0], s), (i, name)


# ------------------------------------------ the kernels' sources on the host

_SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct uint3_ { unsigned x, y, z; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) longlong2 { long long x, y; };
inline thread_local uint3_ threadIdx, blockIdx;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline thread_local std::barrier<>* host_barrier;
inline thread_local int* host_smem;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
// A warp: its 32 lanes share a barrier and two exchange buffers of one
// 64-bit slot a lane.  Every warp function below is a full-warp one (the
// kernels pass 0xffffffff): each lane writes its slot of the buffer this
// call uses, all wait, each reads.  Calls alternate buffers: a lane
// rewrites one only after passing the next call's barrier, which every
// lane reaches after its read.
struct HostWarp {
  std::barrier<> bar{32};
  uint64_t slot[2][32];
};
inline thread_local HostWarp* host_warp;
inline thread_local unsigned host_lane, host_parity;
inline uint64_t* host_exchange(uint64_t w) {
  uint64_t* slots = host_warp->slot[host_parity];
  host_parity ^= 1u;
  slots[host_lane] = w;
  host_warp->bar.arrive_and_wait();
  return slots;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp->bar.arrive_and_wait();
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= 8, "one slot a lane");
  uint64_t w = 0;
  std::memcpy(&w, &v, sizeof(T));
  w = host_exchange(w)[(host_lane ^ lane_mask) & 31u];
  T out;
  std::memcpy(&out, &w, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const uint64_t* slots = host_exchange(pred != 0);
  unsigned m = 0u;
  for (unsigned l = 0; l < 32; ++l) m |= (unsigned)(slots[l] != 0) << l;
  return m;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const uint64_t* slots = host_exchange(v);
  unsigned m = 0u;
  for (unsigned l = 0; l < 32; ++l) m = std::max(m, (unsigned)slots[l]);
  return m;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint64_t* slots = host_exchange(v);
  unsigned m = 0xffffffffu;
  for (unsigned l = 0; l < 32; ++l) m = std::min(m, (unsigned)slots[l]);
  return m;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
using std::max;
using std::min;
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class K, class... A>
void host_launch(K kernel, int grid, int threads, int smem_bytes,
                 cudaStream_t, A... args) {
  for (int bx = 0; bx < grid; ++bx) {
    // NaN bit patterns, so a read of an unwritten word shows
    std::vector<int> smem(smem_bytes / 4 + 1, 0x7fc00001);
    std::barrier<> bar(threads);
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(std::make_unique<HostWarp>());
    std::vector<std::thread> block;
    for (int t = 0; t < threads; ++t)
      block.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)bx, 0, 0};
        host_barrier = &bar;
        host_smem = smem.data();
        host_warp = warps[t / 32].get();
        host_lane = (unsigned)t % 32u;
        host_parity = 0u;
        kernel(args...);
      });
    for (auto& th : block) th.join();
  }
}
"""


def _host_source(cuda_source: str) -> str:
    src = cuda_source.replace("#include <cuda_runtime.h>",
                              '#include "host_shim.h"')
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) int (\w+)\[\];",
        r"int* \1 = host_smem;", src)
    src, n_launch = re.subn(r"(\w+)<<<(.*?)>>>\(", r"host_launch(\1, \2, ",
                            src, flags=re.S)
    assert (n_smem, n_launch) == (1, 1), "kernel source changed: update shim"
    return src


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """``{name: (wrapper module, host-built library)}`` of both kernels."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("postprocess_kernels_host")
    (out / "host_shim.h").write_text(_SHIM)
    libs = {}
    for name, module in (("greedy_match", tgm), ("group_fold", tgf)):
        with open(_cuda_build.source(name)) as f:
            (out / f"{name}.cpp").write_text(_host_source(f.read()))
        path = str(out / f"{name}.so")
        subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-pthread", "-shared", "-fPIC", "-o", path,
                        str(out / f"{name}.cpp")], check=True, timeout=300)
        lib = module.bind(ctypes.CDLL(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = (module, lib)
    return libs


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("name", MATCH_CASES + ("crowd", "ties_k48",
                                                "ties_k96"))
def test_greedy_match_kernel_source_matches_plain_on_host(host_libs, name,
                                                          frames):
    """The planted cases; the crowd: a full K = 32 limb on every limb (32
    steps a block), with a NaN on a valid candidate of one limb (taken
    first, so that limb stops at once) and a limb of signed zeros; ties at
    K = 48 and 96 (two and four 32-column words a row), four limbs a
    frame."""
    module, lib = host_libs["greedy_match"]
    k = {"full_limb": 32, "crowd": 32, "ties_k48": 48, "ties_k96": 96
         }.get(name, 8)
    args = [_t(x) for x in _match_case(
        {"crowd": "full_limb"}.get(name, name.split("_k")[0]),
        np.random.RandomState(2), frames=frames, k=k)]
    if name in ("full_limb", "ties_k48", "ties_k96"):  # four limbs a frame
        args = [x[:, :4] for x in args]
    if name == "ties":
        args[0][0, 3, 1, 2] = float("nan")    # torch.argmax's NaN is first
    if name == "crowd":
        args[0][0, 5, 7, 9] = float("nan")
        # a limb of signed zeros: every step a tie of -0 and +0, taken in
        # flat order as torch.argmax does
        args[0][0, 7] = torch.where(torch.rand(k, k) < 0.5, -0.0, 0.0)
    got = module._launch(lib, *args, None)
    ref = tpaf.greedy_match(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("seed,cap", FOLD_CASES + (
    ("crowd", 64), ("crowd", 128), ("wide", 40), ("wide", 64)))
def test_group_fold_kernel_source_matches_plain_on_host(host_libs, seed, cap,
                                                        frames):
    """The planted cases; the crowd (608 steps a frame) at the default
    table and ``chip_smoke.py``'s; wide tables (12 slots: over 32 rows
    created, so the match test reads a second 32-row chunk), saturated at
    S = 40."""
    module, lib = host_libs["group_fold"]
    tables = {"crowd": lambda: crowd_tables(np.random.RandomState(8),
                                            (frames,)),
              "wide": lambda: fold_tables(np.random.RandomState(3),
                                          (frames,), k=WIDE_SLOTS)
              }.get(seed, lambda: _fold_case(seed))()
    a, b, s, v, p = (_t(x[:frames]) for x in tables)
    cfg = _fold_cfg(cap)
    thresh = (cfg.n_subset_limbs_thresh, cfg.subset_score_thresh)
    got = module._launch(lib, *module._limbs(NUM_LIMBS), a, b, s, v, p, cap,
                         *thresh, None)
    ref = tgroup.fold_connections(a, b, s, v, p, cap, *thresh)
    for g, r, field in zip(got, ref, ref._fields):
        assert g.dtype == r.dtype and torch.equal(g, r), field
    if seed == "wide":
        created = (ref.joint_slot >= 0).any(-1).sum(-1) + ref.spawns_suppressed
        assert int(created.max()) > 32


@pytest.mark.parametrize("case", ["planted", "crowd"])
def test_group_fold_kernel_source_takes_body25_odd_parts(host_libs, case):
    """BODY_25's 25 parts (an odd table width, stored one slot a store)
    and 26 pairs with its non-spawning shoulder-ear pairs: the host build
    of the kernel equals the plain fold over the topology."""
    module, lib = host_libs["group_fold"]
    rng = np.random.RandomState(25)
    shape = dict(n_limbs=BODY25.num_limbs, n_joints=BODY25.num_joints)
    tables = (fold_tables(rng, (3,), **shape) if case == "planted"
              else crowd_tables(rng, (2,), people=20, **shape))
    a, b, s, v, p = (_t(x) for x in tables)
    cap = 64
    got = module._launch(lib, *module._limbs(BODY25.num_limbs, BODY25), a, b,
                         s, v, p, cap, 2, 0.3, None)
    ref = tgroup.fold_connections(a, b, s, v, p, cap, 2, 0.3, BODY25)
    assert tuple(ref.joint_slot.shape[-2:]) == (cap, 25)
    for g, r, field in zip(got, ref, ref._fields):
        assert g.dtype == r.dtype and torch.equal(g, r), field
    assert bool(ref.valid.any())


def test_group_fold_kernel_source_on_scenes_matches_plain(host_libs):
    """Real connections of three rendered scenes, the default table."""
    from tpupose_torch.ops.peaks import find_peaks

    module, lib = host_libs["group_fold"]
    pafs, hms = _scenes()
    peaks = find_peaks(_t(hms)[:, :-1], CFG.gaussian_sigma,
                       CFG.heatmap_peak_thresh, CFG.max_peaks_per_joint)
    conns = tpaf.compute_connections(_t(pafs), peaks, HW[1], CFG, LIMBS_FROM,
                                     LIMBS_TO)
    args = (*conns, peaks.score, CFG.max_subsets, CFG.n_subset_limbs_thresh,
            CFG.subset_score_thresh)
    got = module._launch(lib, *module._limbs(NUM_LIMBS), *args, None)
    ref = tgroup.fold_connections(*args)
    for g, r, field in zip(got, ref, ref._fields):
        assert torch.equal(g, r), field
    assert bool(ref.valid.any(dim=1).all())


# ------------------------------------------------- the ops and export


def test_ops_take_the_frame_axis_on_cpu():
    """``tpupose::greedy_match`` and ``tpupose::group_keypoints`` on CPU
    tensors with a frame axis: the plain versions, uncounted; their fake
    implementations give the shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import library  # noqa: F401  registers the ops

    ops = torch.ops.tpupose
    match_args = [_t(x) for x in _match_case("ties",
                                             np.random.RandomState(3))]
    a, b, s, v, p = (_t(x) for x in _fold_case(4))
    fold_args = (a, b, s, v, p, 8, 2.0, 0.3)
    tables = ([int(j) for j in COCO18.limbs_from],
              [int(j) for j in COCO18.limbs_to], list(COCO18.spawns))
    launches = (tgm.greedy_match.launches, tgf.group_fold.launches)
    for op, args, ref in (
            (ops.greedy_match, match_args, tpaf.greedy_match(*match_args)),
            (ops.group_keypoints, fold_args + tables,
             tgroup.fold_connections(*fold_args))):
        got = op(*args)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = op(*args)
        assert [(f.shape, f.dtype) for f in fake] == \
            [(r.shape, r.dtype) for r in ref]
    assert (tgm.greedy_match.launches, tgf.group_fold.launches) == launches


def test_exported_fast_batch_program_equals_live_detect_batch():
    """A CPU ``torch.export`` of the fast B = 2 program (one batched
    postprocess through the ops' fake implementations) gives the live
    detector's tables."""
    from torch.utils import _pytree as pytree

    from tpupose_torch.detectors.pose import (PoseDetector, emit_result,
                                              fast_geometry, results_to_host)
    from tpupose_torch.ops.library import traced_ops
    from tpupose_torch.ops.postprocess import PoseResult
    from tpupose_torch.serving import _Program
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(0, 256, (2, 96, 128, 3)
                                              ).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device="cpu", seed=0)
    assert calibrate_output_convs(det, frames[0])
    (in_h, in_w), map_hw = fast_geometry(cfg, 96, 128)
    assert (in_h, in_w) == (96, 128)
    leaves, spec = pytree.tree_flatten(det.program_weights())
    imgs = torch.from_numpy(frames)
    with traced_ops(), torch.no_grad():
        ep = torch.export.export(_Program(det._fast_fn(map_hw), spec),
                                 (leaves, imgs), strict=False)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert {"tpupose.greedy_match.default",
            "tpupose.group_keypoints.default"} <= targets
    with torch.no_grad():
        (host,) = results_to_host([PoseResult(*ep.module()(leaves, imgs))])
    live = det.detect_batch(frames)
    scale = (128 / map_hw[1], 96 / map_hw[0])
    for j, (poses, scores) in enumerate(live):
        got = emit_result(PoseResult(*(f[j] for f in host)), *scale)
        np.testing.assert_array_equal(got[0], poses)
        np.testing.assert_array_equal(got[1], scores)
    assert sum(len(p) for p, _ in live) >= 1
