// The associative-embedding decode's refine, for Hopper (sm_90a): for each
// (person, joint) pair, the pixel of the joint's heatmap that maximises
//
//     det - round(sqrt(d0 * d0 + d1 * d1)),  d = the pixel's two tags minus
//                                            the person's mean tag,
//
// the first maximum in row-major order, as HigherHRNet's
// HeatmapParser.refine takes it (np.argmax).  It replaces no TPU kernel:
// the JAX package has no associative-embedding decoder; it replaces the
// eager PyTorch scoring of tpupose_torch/ops/ae_decode.py (kept there as
// `refine_argmax_plain`), which writes and reads each step of the score
// for every pair and pixel (~76 bytes a pair and pixel).
//
// Arithmetic: each step rounds as PyTorch's eager ops do, explicit _rn
// intrinsics (NVCC_FLAGS leave -fmad on, and a contracted FMA would move a
// rounded distance): __fsub_rn for the differences, __fmul_rn for the
// squares, __fadd_rn for their sum, __fsqrt_rn, rintf (half to even, as
// torch.round), __fsub_rn for the score.
//
// Design: a block scores up to AE_REFINE_GROUP pairs of one joint, so a
// pixel's heatmap value and two tags are read once for all of them (12
// bytes a pixel a group); each thread scores kPixels pixels strided by the
// block and keeps, per pair, the largest 64-bit key (the score's bits in
// an order-preserving map, above the pixel index reversed, so equal scores
// take the smaller index); a warp reduces its keys by shuffles and one
// lane a warp takes atomicMax on the pair's key.  -0 is made +0 first, as
// np.argmax compares them equal.  Bound: bytes, 12 x pixels a group.

#include <cuda_runtime.h>
#include <stdint.h>

// Must equal GROUP in tpupose_torch/ops/ae_decode.py.
#define AE_REFINE_GROUP 16

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 8;     // pixels a thread scores

__device__ __forceinline__ unsigned long long key_of(float score,
                                                     unsigned int pixel) {
  score = __fadd_rn(score, 0.0f);  // -0 + 0 = +0
  const unsigned int b = __float_as_uint(score);
  const unsigned int ordered = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)ordered << 32) | (0xffffffffu - pixel);
}

// det: (J, hw); tags: (2, J, hw); means: (K, 2); groups: n rows of (joint,
// first, count) into `order`, the pairs' indices grouped by joint; best:
// (K,) keys, zero on entry.
__global__ void __launch_bounds__(kThreads)
ae_refine_kernel(const float* __restrict__ det, const float* __restrict__ tags,
                 const float* __restrict__ means,
                 const int* __restrict__ groups, const int* __restrict__ order,
                 unsigned long long* __restrict__ best, int nj, int hw) {
  __shared__ float m0[AE_REFINE_GROUP], m1[AE_REFINE_GROUP];
  __shared__ int pair[AE_REFINE_GROUP];
  const int joint = groups[3 * blockIdx.y];
  const int first = groups[3 * blockIdx.y + 1];
  const int count = groups[3 * blockIdx.y + 2];
  if (threadIdx.x < count) {
    const int p = order[first + threadIdx.x];
    pair[threadIdx.x] = p;
    m0[threadIdx.x] = means[2 * p];
    m1[threadIdx.x] = means[2 * p + 1];
  }
  __syncthreads();

  unsigned long long local[AE_REFINE_GROUP];
#pragma unroll
  for (int i = 0; i < AE_REFINE_GROUP; ++i) local[i] = 0ull;
  const float* d = det + (size_t)joint * hw;
  const float* t0 = tags + (size_t)joint * hw;
  const float* t1 = tags + ((size_t)nj + joint) * hw;
  const int base = blockIdx.x * kThreads * kPixels + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = base + k * kThreads;
    if (p < hw) {
      const float dv = __ldg(d + p);
      const float a = __ldg(t0 + p);
      const float b = __ldg(t1 + p);
#pragma unroll
      for (int i = 0; i < AE_REFINE_GROUP; ++i) {
        if (i < count) {
          const float e0 = __fsub_rn(a, m0[i]);
          const float e1 = __fsub_rn(b, m1[i]);
          const float s = __fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1));
          const float score = __fsub_rn(dv, rintf(__fsqrt_rn(s)));
          const unsigned long long key = key_of(score, (unsigned int)p);
          local[i] = key > local[i] ? key : local[i];
        }
      }
    }
  }
  // `count` is the block's, so every lane takes each shuffle
#pragma unroll
  for (int i = 0; i < AE_REFINE_GROUP; ++i) {
    if (i < count) {
      unsigned long long v = local[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
      }
      if ((threadIdx.x & 31) == 0 && v != 0ull) atomicMax(best + pair[i], v);
    }
  }
}

}  // namespace

extern "C" int ae_refine_launch(const float* det, const float* tags,
                                const float* means, const int* groups,
                                const int* order, unsigned long long* best,
                                int n_groups, int nj, int hw, void* stream) {
  if (n_groups <= 0 || n_groups > 65535 || nj <= 0 || hw <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((hw + kThreads * kPixels - 1) / (kThreads * kPixels),
                  n_groups);
  ae_refine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      det, tags, means, groups, order, best, nj, hw);
  return (int)cudaGetLastError();
}

extern "C" const char* ae_refine_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
