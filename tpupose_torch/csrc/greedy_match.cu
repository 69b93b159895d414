// Greedy 1:1 limb matching for Hopper (sm_90a): per (frame, limb), take the
// best still-free candidate connection until min(n_a, n_b) are taken.
//
// Replaces the JAX package's device loop tpupose/ops/paf.py::greedy_match,
// an XLA while_loop of masked argmaxes that detect_batch vmaps over limbs
// and frames (it is no Pallas kernel; PyTorch has no device-side loop, so
// the port's counterpart is this kernel).  Semantics are those of
// tpupose_torch/ops/paf.py::greedy_match, bit for bit: candidates are
// (a, b) pairs of a K x K table; each step takes the free candidate first
// in (score descending, flat index a * K + b ascending) order, which is
// torch.argmax's and jnp.argmax's first maximum (a NaN counts as the
// largest, as torch.argmax's does), and stops at a non-finite best or
// once min(n_a, n_b) are taken.  No arithmetic touches a score.
//
// Grid: one block per (frame, limb).  Each step every thread scans its
// strided share of the K^2 candidates (kThreads = 128: 8 each at K = 32),
// a shared-memory tree reduction finds the block's best, and thread 0
// marks its endpoints used.  Bound: latency, not bytes or operations: the
// steps are sequential (one per accepted connection, ~people), each a
// scan of K^2 cached bytes and floats and log2(kThreads) barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a power of two: the tree reduction halves

// Whether candidate (sa, ia) comes before (sb, ib): a NaN first, then the
// larger score, then the smaller flat index.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  const bool na = sa != sa, nb = sb != sb;
  if (na || nb) return na && (!nb || ia < ib);
  if (sa != sb) return sa > sb;
  return ia < ib;
}

// score: (N, K, K) float32; valid: (N, K, K) uint8; n_a, n_b: (N,) int64;
// out_a, out_b: (N, K) int64; out_s: (N, K) float32; out_v: (N, K) uint8.
__global__ void __launch_bounds__(kThreads)
greedy_match_kernel(const float* __restrict__ score,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ n_a,
                    const int64_t* __restrict__ n_b, int64_t* out_a,
                    int64_t* out_b, float* out_s, uint8_t* out_v, int K) {
  extern __shared__ __align__(16) int smem[];
  int* used_a = smem;                    // K
  int* used_b = used_a + K;              // K
  int* taken_a = used_b + K;             // K
  int* taken_b = taken_a + K;            // K
  float* taken_s = (float*)(taken_b + K);  // K
  float* red_s = taken_s + K;            // kThreads
  int* red_i = (int*)(red_s + kThreads);  // kThreads
  int* state = red_i + kThreads;         // [0] go on, [1] taken

  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const int kk = K * K;
  const float* sc = score + row * kk;
  const uint8_t* va = valid + row * kk;
  for (int i = t; i < K; i += kThreads) used_a[i] = used_b[i] = 0;
  if (t == 0) state[1] = 0;
  const long long max_conn = n_a[row] < n_b[row] ? n_a[row] : n_b[row];
  __syncthreads();

  for (int step = 0; step < K; ++step) {
    if (state[1] >= max_conn) break;  // uniform: read after a barrier
    float best_s = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = t; i < kk; i += kThreads) {
      const int a = i / K, b = i - a * K;
      if (!va[i] || used_a[a] || used_b[b]) continue;
      const float s = sc[i];
      if (before(s, i, best_s, best_i)) {
        best_s = s;
        best_i = i;
      }
    }
    red_s[t] = best_s;
    red_i[t] = best_i;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (t < w && before(red_s[t + w], red_i[t + w], red_s[t], red_i[t])) {
        red_s[t] = red_s[t + w];
        red_i[t] = red_i[t + w];
      }
      __syncthreads();
    }
    if (t == 0) {
      const float s = red_s[0];
      const bool take = isfinite(s);
      if (take) {
        const int i = red_i[0], a = i / K, b = i - a * K, n = state[1];
        used_a[a] = used_b[b] = 1;
        taken_a[n] = a;
        taken_b[n] = b;
        taken_s[n] = s;
        state[1] = n + 1;
      }
      state[0] = take;
    }
    __syncthreads();
    if (!state[0]) break;
  }

  const int n = state[1];
  for (int i = t; i < K; i += kThreads) {
    const long long o = row * K + i;
    const bool on = i < n;
    out_a[o] = on ? taken_a[i] : -1;
    out_b[o] = on ? taken_b[i] : -1;
    out_s[o] = on ? taken_s[i] : 0.0f;
    out_v[o] = on;
  }
}

}  // namespace

// Launches one block per row on `stream` and returns cudaGetLastError()
// (0 on success).  N rows (frames x limbs) of K x K candidates.
extern "C" int greedy_match_launch(const float* score, const uint8_t* valid,
                                   const int64_t* n_a, const int64_t* n_b,
                                   int64_t* out_a, int64_t* out_b,
                                   float* out_s, uint8_t* out_v, int N, int K,
                                   void* stream) {
  const int smem = (5 * K + 2 * kThreads + 2) * 4;
  if (N <= 0 || K <= 0 || K > 46340 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  greedy_match_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      score, valid, n_a, n_b, out_a, out_b, out_s, out_v, K);
  return (int)cudaGetLastError();
}

extern "C" const char* greedy_match_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
