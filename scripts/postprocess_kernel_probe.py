#!/usr/bin/env python3
"""Where the time of the two postprocess kernels goes, on one NVIDIA GPU.

    python3 scripts/postprocess_kernel_probe.py      # from the repository root

1. The dependent latency, in SM cycles, of the warp operations the kernels'
   steps are built from: ``__reduce_max_sync`` / ``__reduce_min_sync``,
   ``__shfl_xor_sync``, ``__ballot_sync``, a shared-memory load, a
   shared store then ``__syncwarp`` then a load, ``__popc`` + ``__ffs``,
   an integer multiply-add (one warp, a chain of 4096, ``clock64``).
2. Copies of ``tpupose_torch/csrc/greedy_match.cu`` and ``group_fold.cu``
   with ``clock64`` read between their phases (staging, the steps, the
   outputs), launched through the wrappers' own ``_launch`` on the crowd
   of ``tests/postprocess_cases.py`` (B = 1 and 8) and, for the fold, a
   table of one person (19 steps): cycles per phase, steps, cycles a step
   (mean over blocks).  The copies' outputs are overwritten by the
   counts; the real kernels are untouched.

Prints the card's name and power limit, then one JSON line.  Builds into
``tpupose_torch/_build/`` (not tracked).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LATENCY_CU = r"""
#include <cuda_runtime.h>
template <int KIND>
__global__ void chain(long long* out, int iters) {
  __shared__ unsigned sm[64];
  const unsigned lane = threadIdx.x;
  sm[lane] = lane;
  sm[lane + 32] = lane;
  __syncwarp();
  unsigned v = lane;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
    if (KIND == 0) v = __reduce_max_sync(0xffffffffu, v) + lane;
    if (KIND == 1) v = __reduce_min_sync(0xffffffffu, v) + lane;
    if (KIND == 2) v = __shfl_xor_sync(0xffffffffu, v, 1) + 1u;
    if (KIND == 3) v = __ballot_sync(0xffffffffu, v & 1u) + lane;
    if (KIND == 4) v = sm[v & 63u];
    if (KIND == 5) {
      sm[lane] = v + 1u;
      __syncwarp();
      v = sm[(lane + 1) & 31u];
    }
    if (KIND == 6) v = __popc(v) + (unsigned)__ffs(v) + lane;
    if (KIND == 7) v = v * 3u + 1u;
  }
  const long long t1 = clock64();
  if (lane == 0) out[KIND] = t1 - t0;
  if (v == 0xdeadbeefu) out[8] = v;
}
extern "C" int run(long long* out, int iters) {
  chain<0><<<1, 32>>>(out, iters);
  chain<1><<<1, 32>>>(out, iters);
  chain<2><<<1, 32>>>(out, iters);
  chain<3><<<1, 32>>>(out, iters);
  chain<4><<<1, 32>>>(out, iters);
  chain<5><<<1, 32>>>(out, iters);
  chain<6><<<1, 32>>>(out, iters);
  chain<7><<<1, 32>>>(out, iters);
  return (int)cudaDeviceSynchronize();
}
"""
_LATENCY_NAMES = ("reduce_max", "reduce_min", "shfl_xor", "ballot", "lds",
                  "sts_syncwarp_lds", "popc_ffs", "imad")


def _build(name, source):
    """nvcc ``source`` into a shared library under the build directory."""
    from tpupose_torch.ops import _cuda_build

    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_cuda_build.BUILD_DIR, f"{name}.cu")
    so = os.path.join(_cuda_build.BUILD_DIR, f"{name}.so")
    with open(cu, "w") as f:
        f.write(source)
    subprocess.run([_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-o", so,
                    cu], check=True, timeout=600)
    return ctypes.CDLL(so)


def _sub(source, old, new):
    if old not in source:
        raise AssertionError(f"source changed: {old!r} not found")
    return source.replace(old, new, 1)


def _instrumented(name):
    """The kernel's source with clock64 phases written over its outputs."""
    from tpupose_torch.ops import _cuda_build

    with open(_cuda_build.source(name)) as f:
        src = f.read()
    smem = "  extern __shared__ __align__(16) int smem[];\n"
    src = _sub(src, smem, "  const long long t0 = clock64();\n" + smem)
    if name == "greedy_match":
        src = _sub(src, "  // 3. the steps",
                   "  const long long t1 = clock64();\n  // 3. the steps")
        src = _sub(src, "  // 4. the outputs",
                   "  const long long t2 = clock64();\n  // 4. the outputs")
        return _sub(
            src, "    out_v[o + i] = i < n;\n  }\n}",
            "    out_v[o + i] = i < n;\n  }\n"
            "  const long long t3 = clock64();\n"
            "  __syncwarp();\n  if (lane == 0) { out_s[o] = t1 - t0; "
            "out_s[o + 1] = t2 - t1; out_s[o + 2] = t3 - t2; "
            "out_s[o + 3] = n; }\n}")
    src = _sub(src, "  // 4. the fold",
               "  const long long t1 = clock64();\n  // 4. the fold")
    src = _sub(src, "  // 5. final filter",
               "  const long long t2 = clock64();\n  // 5. final filter")
    return _sub(
        src, "  if (lane == 0) out_suppressed[frame] = suppressed;\n}",
        "  if (lane == 0) out_suppressed[frame] = suppressed;\n"
        "  const long long t3 = clock64();\n  __syncwarp();\n"
        "  if (lane == 0) { out_score[frame * S] = t1 - t0; "
        "out_score[frame * S + 1] = t2 - t1; out_score[frame * S + 2] = "
        "t3 - t2; out_score[frame * S + 3] = n_valid; }\n}")


def main() -> int:
    sys.path.insert(0, _REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("postprocess_kernel_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke
    from tpupose_torch.config import NUM_LIMBS
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    out = {}

    lib = _build("warp_latency", _LATENCY_CU)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cycles = torch.zeros(9, dtype=torch.int64, device="cuda")
    iters = 4096
    if lib.run(cycles.data_ptr(), iters) != 0:
        raise RuntimeError("latency kernels failed")
    out["dependent_cycles"] = {
        n: c / iters for n, c in zip(_LATENCY_NAMES, cycles.tolist())}

    cases = chip_smoke._cases()
    stream = torch.cuda.current_stream().cuda_stream
    g_lib = gm.bind(_build("greedy_match_probe",
                           _instrumented("greedy_match")))
    f_lib = gf.bind(_build("group_fold_probe", _instrumented("group_fold")))
    for b in (1, 8):
        m_args = [torch.from_numpy(x).cuda() for x in cases.match_tables(
            np.random.RandomState(6), "full_limb", (b, NUM_LIMBS), 32)]
        for _ in range(3):
            got = gm._launch(g_lib, *m_args, stream)
        torch.cuda.synchronize()
        c = got[2][..., :4].reshape(-1, 4).double().mean(0).tolist()
        out[f"greedy_match_crowd_b{b}"] = {
            "stage": c[0], "steps": c[1], "outputs": c[2], "n_steps": c[3],
            "cycles_a_step": c[1] / max(c[3], 1)}
        for people in (1, 32):
            f_args = [torch.from_numpy(x).cuda() for x in cases.crowd_tables(
                np.random.RandomState(8), (b,), people=people)]
            for _ in range(3):
                got = gf._launch(f_lib, *gf._limbs(NUM_LIMBS), *f_args, 128,
                                 2, 0.3, stream)
            torch.cuda.synchronize()
            c = got[1][..., :4].reshape(-1, 4).double().mean(0).tolist()
            out[f"group_fold_people{people}_b{b}"] = {
                "stage": c[0], "steps": c[1], "outputs": c[2],
                "n_steps": c[3], "cycles_a_step": c[1] / max(c[3], 1)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
