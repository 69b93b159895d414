"""The blur+NMS CUDA kernel's own source, run on the CPU.

``tpupose_torch/csrc/blur_nms.cu`` has no interpret mode, but its C++ is
plain enough for g++ once a small shim stands in for CUDA: the qualifiers
become nothing, ``float4`` a struct, each block's threads ``std::thread``s
sharing a ``std::barrier`` for ``__syncthreads`` and a buffer for its
shared memory, and the launch a loop over the grid.  Products and sums
stay single-precision, rounded on their own (``-ffp-contract=off``), so
the kernel's indexing, mirroring, chunking and tap order are held here bit
for bit against ``blur_nms_reference`` at ragged, thin, smaller-than-radius
and edge-strip shapes and at several radii.  The card's own compiler and
the hardware are checked by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops import blur_nms as bn

_SHIM = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx, blockIdx;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline thread_local std::barrier<>* host_barrier;
inline thread_local int* host_smem;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K, class... A>
void host_launch(K kernel, dim3 grid, int threads, int smem_bytes,
                 cudaStream_t, A... args) {
  const int words = (smem_bytes > 64 * 1024 ? smem_bytes : 64 * 1024) / 4;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        // NaN bit patterns, so a read of an unwritten slot shows
        std::vector<int> smem(words, 0x7fc00001);
        std::barrier<> bar(threads);
        std::vector<std::thread> block;
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {bx, by, bz};
            host_barrier = &bar;
            host_smem = smem.data();
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
        r"(?:extern )?__shared__ __align__\(16\) int (\w+)\[[^\]]*\];",
        r"int* \1 = host_smem;", src)
    src, n_launch = re.subn(r"(\w+(?:<R>)?)<<<(.*?)>>>\(",
                            r"host_launch(\1, \2, ", src, flags=re.S)
    src = re.sub(r'asm\(""\s*:\s*"\+l"\([^)]*\)\);', "", src)
    # the unrolled kernel (radii 0-16) and the run-time-tap one (17-255)
    assert (n_smem, n_launch) == (2, 2), "blur_nms.cu changed: update shim"
    return src


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("blur_nms_host")
    (out / "host_shim.h").write_text(_SHIM)
    with open(_cuda_build.source("blur_nms")) as f:
        (out / "blur_nms_host.cpp").write_text(_host_source(f.read()))
    lib_path = str(out / "blur_nms_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-o", lib_path,
                    str(out / "blur_nms_host.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_nms_launch.argtypes = [p, p, p, i, i, i,
                                    ctypes.POINTER(ctypes.c_float), i,
                                    ctypes.c_float, p]
    lib.blur_nms_launch.restype = i
    return lib


@pytest.mark.parametrize("shape,sigma", [
    ((3, 7, 9), 2.5),        # smaller than the radius: mirrors repeat
    ((2, 70, 300), 2.5),     # edge and interior strips, ragged band
    ((1, 33, 131), 2.5),     # ragged strip and band, W % 4 != 0
    ((2, 5, 300), 2.5),      # thin
    ((2, 300, 5), 2.5),
    ((1, 64, 256), 2.5),     # whole strips and bands
    ((1, 40, 140), 1.0),     # radius 4
    ((1, 40, 140), 4.0),     # radius 16, the largest unrolled one
    ((1, 9, 11), 0.1),       # radius 0
    # the run-time-tap kernel, radius r at sigma r / 4: every radius from
    # 17 to 32 over maps smaller than the radius, ragged and thin ones
    *[(((3, 7, 9), (1, 40, 140), (2, 33, 131), (2, 5, 70), (1, 70, 5),
        (1, 64, 256))[r % 6], r / 4) for r in range(17, 33)],
    ((1, 20, 30), 63.75),    # radius 255, the largest the kernel takes
])
def test_blur_nms_kernel_source_matches_reference_on_host(host_kernel,
                                                          shape, sigma):
    rng = np.random.RandomState(sum(shape))
    hm = rng.rand(*shape).astype(np.float32) * 0.3
    for c in range(shape[0]):       # peaks anywhere, borders included
        for _ in range(3):
            hm[c, rng.randint(shape[1]), rng.randint(shape[2])] += 0.7
    x = torch.from_numpy(hm)
    c_taps, radius = bn._taps(sigma)
    smoothed = torch.full_like(x, float("nan"))
    mask = torch.full(shape, 7, dtype=torch.uint8)
    err = host_kernel.blur_nms_launch(
        x.data_ptr(), smoothed.data_ptr(), mask.data_ptr(), *shape, c_taps,
        radius, 0.05, None)
    assert err == 0
    ref_s, ref_m = bn.blur_nms_reference(x, sigma, 0.05)
    np.testing.assert_array_equal(smoothed.numpy().view(np.int32),
                                  ref_s.numpy().view(np.int32))
    np.testing.assert_array_equal(mask.numpy(), ref_m.numpy())
