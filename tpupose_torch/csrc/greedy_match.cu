// Greedy 1:1 limb matching for Hopper (sm_90a): per (frame, limb), take the
// best still-free candidate connection until min(n_a, n_b) are taken.
//
// Replaces the JAX package's device loop tpupose/ops/paf.py::greedy_match
// (:102), an XLA while_loop of masked argmaxes that detect_batch vmaps over
// limbs and frames (it is no Pallas kernel; PyTorch has no device-side
// loop, so the port's counterpart is this kernel).  Semantics are those of
// tpupose_torch/ops/paf.py::greedy_match, bit for bit: candidates are
// (a, b) pairs of a K x K table; each step takes the free candidate first
// in (score descending, flat index a * K + b ascending) order, which is
// torch.argmax's and jnp.argmax's first maximum (a NaN counts as the
// largest, as torch.argmax's does), and stops at a non-finite best or
// once min(n_a, n_b) are taken.  No arithmetic touches a score.
//
// Bound: latency.  The steps are sequential (one per accepted connection,
// about one per person), so neither bytes (5 K^2 a row, read once) nor
// comparisons bound it: the chain of dependent steps does.  The first
// design (PR 12) rescanned all K^2 candidates from device memory every
// step, with an integer division per candidate, then reduced them in a
// 7-level shared-memory tree with a barrier per level: 0.42 us a scan.
//
// This design: one warp per block, one block per (frame, limb), nothing
// read from device memory between staging and the outputs.  Each candidate
// is staged in shared memory (row stride K | 1, so 32 lanes' rows or
// columns fall in 32 banks) as an unsigned key in the order `before` gave
// in PR 12: a NaN first, then the larger score, -0 tying +0, and 0 where
// the candidate is not valid.  With the index a << s | b, which orders
// (a, b) as a * K + b does, the larger key and then the smaller index is
// the same total order, so each warp argmax is exact: __reduce_max_sync of
// the keys, then __reduce_min_sync of the indices at that key, the same
// winner on every lane.  Lane l holds in registers the best (key, index)
// of its rows a = l + 32 q and which of its columns c = l + 32 w are
// taken.  A step is one argmax over the lanes' bests; the winning row is
// retired, and only rows whose best was in the taken column rescan, all
// lanes together (a column each, branch-free), by the same two reductions.
// The accepted (a, b) go to shared memory; the outputs are written once at
// the end, their scores read back from the input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
// keys of -inf and +inf: a best outside them is none (0), an infinity or
// a NaN, and stops the row
constexpr unsigned kKeyNegInf = 0x007fffffu;
constexpr unsigned kKeyPosInf = 0xff800000u;

// An unsigned key in the order of candidates' scores: a NaN above all, then
// the larger score, -0 equal to +0; 0 is below every score (none).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return s != s ? 0xffffffffu : k;
}

// score: (N, K, K) float32; valid: (N, K, K) uint8; n_a, n_b: (N,) int64;
// out_a, out_b: (N, K) int64; out_s: (N, K) float32; out_v: (N, K) uint8.
// W: 32-column words of a row (K <= 32 W), a power of two.
template <int W>
__global__ void __launch_bounds__(32)
greedy_match_kernel(const float* __restrict__ score,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ n_a,
                    const int64_t* __restrict__ n_b, int64_t* out_a,
                    int64_t* out_b, float* out_s, uint8_t* out_v, int K) {
  constexpr int kShift = W == 1 ? 5 : (W == 2 ? 6 : 7);  // index a << s | b
  constexpr unsigned kCol = (1u << kShift) - 1u;
  extern __shared__ __align__(16) int smem[];
  const int P = K | 1;                                // row stride
  unsigned* key = (unsigned*)smem;                    // K x P, + 128 slack
  unsigned* taken = key + K * P + 128;                // K: accepted a << s | b

  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  const long long o = row * K;
  const int kk = K * K;
  const float* g_sc = score + row * kk;
  const uint8_t* g_va = valid + row * kk;

  // 1. stage the keys, flat and coalesced; (a, c) of a lane's next
  // element advanced without a division
  if ((kk & 3) == 0 && ((uintptr_t)g_sc & 15) == 0 &&
      ((uintptr_t)g_va & 3) == 0) {
    const int da = 128 / K, dc = 128 - da * K;
    int a = 4 * lane / K, c = 4 * lane - a * K;
#pragma unroll 8
    for (int i = lane; i < kk / 4; i += 32) {
      const float4 s = ((const float4*)g_sc)[i];
      const uint32_t v = ((const uint32_t*)g_va)[i];
      const float f[4] = {s.x, s.y, s.z, s.w};
      int ea = a, ec = c;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        key[ea * P + ec] = ((v >> (8 * t)) & 0xffu) ? order_key(f[t]) : 0u;
        if (++ec == K) {
          ec = 0;
          ++ea;
        }
      }
      a += da;
      c += dc;
      if (c >= K) {
        c -= K;
        ++a;
      }
    }
  } else {
    const int da = 32 / K, dc = 32 - da * K;
    int a = lane / K, c = lane - a * K;
#pragma unroll 4
    for (int i = lane; i < kk; i += 32) {
      key[a * P + c] = g_va[i] ? order_key(g_sc[i]) : 0u;
      a += da;
      c += dc;
      if (c >= K) {
        c -= K;
        ++a;
      }
    }
  }
  __syncwarp();

  // 2. each of this lane's rows: its best candidate (key 0: none), a 32-
  // column word at a time: the largest key (four running maxima), then the
  // first column holding it
  unsigned rk[W], ri[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int a = 32 * q + lane;
    unsigned bk = 0u, bi = kNoIndex;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned kv[32], m4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        kv[c] = a < K && 32 * w + c < K ? key[a * P + 32 * w + c] : 0u;
        m4[c & 3] = max(m4[c & 3], kv[c]);
      }
      const unsigned mw = max(max(m4[0], m4[1]), max(m4[2], m4[3]));
      unsigned at = 0u;
#pragma unroll
      for (int c = 0; c < 32; ++c) at |= (unsigned)(kv[c] == mw) << c;
      if (mw > bk) {
        bk = mw;
        bi = ((unsigned)a << kShift) | (unsigned)(32 * w + __ffs(at) - 1);
      }
    }
    rk[q] = bk;
    ri[q] = bi;
  }
  // 3. the steps: a warp argmax of the lanes' bests; the winning row is
  // retired, and the rows whose best was in the taken column rescan, all
  // lanes together, by the same two reductions
  unsigned col_taken = 0u;  // bit w: column 32 w + lane is taken
  auto lane_best = [&](unsigned& lk, unsigned& li) {
    lk = 0u;
    li = kNoIndex;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      if (rk[q] > lk || (rk[q] == lk && ri[q] < li)) {
        lk = rk[q];
        li = ri[q];
      }
    }
  };
  unsigned lk, li;
  lane_best(lk, li);
  const long long max_conn = n_a[row] < n_b[row] ? n_a[row] : n_b[row];
  int n = 0;
  while (n < max_conn) {
    const unsigned mk = __reduce_max_sync(kFull, lk);
    if (mk <= kKeyNegInf || mk >= kKeyPosInf) break;  // none, inf or NaN
    const unsigned wi = __reduce_min_sync(kFull, lk == mk ? li : kNoIndex);
    const int a = (int)(wi >> kShift), b = (int)(wi & kCol);
    if (lane == 0) taken[n] = wi;
    ++n;
    if ((b & 31) == lane) col_taken |= 1u << (b >> 5);
    bool changed = false;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      if (32 * q + lane == a) {
        rk[q] = 0u;
        ri[q] = kNoIndex;
        changed = true;
      }
      unsigned need = __ballot_sync(kFull, rk[q] != 0u &&
                                               (ri[q] & kCol) == (unsigned)b);
      while (need) {
        const int r = 32 * q + __ffs(need) - 1;
        need &= need - 1u;
        // this lane's candidate in row r: its columns' largest free key
        unsigned bk = 0u, bi = kNoIndex;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int c = 32 * w + lane;
          const unsigned k =
              c < K && !((col_taken >> w) & 1u) ? key[r * P + c] : 0u;
          if (k > bk) {
            bk = k;
            bi = ((unsigned)r << kShift) | (unsigned)c;
          }
        }
        const unsigned nk = __reduce_max_sync(kFull, bk);
        const unsigned ni = __reduce_min_sync(kFull, bk == nk ? bi : kNoIndex);
        if (lane == (r & 31)) {
          rk[q] = nk;
          ri[q] = nk ? ni : kNoIndex;
          changed = true;
        }
      }
    }
    if (changed) lane_best(lk, li);
  }
  __syncwarp();

  // 4. the outputs, each score read back from the input (bit for bit)
  for (int i = lane; i < K; i += 32) {
    int a = -1, b = -1;
    float s = 0.0f;
    if (i < n) {
      a = (int)(taken[i] >> kShift);
      b = (int)(taken[i] & kCol);
      s = g_sc[a * K + b];
    }
    out_a[o + i] = a;
    out_b[o + i] = b;
    out_s[o + i] = s;
    out_v[o + i] = i < n;
  }
}

// Shared memory of one block at K: the keys (K x (K | 1) and 128 of
// slack) and the accepted indices (K).  ops/greedy_match.py sizes nothing:
// at K <= 128 this is at most 66,688 bytes.
long long smem_bytes(int K) {
  return 4LL * ((long long)K * (K | 1) + 128 + K);
}

}  // namespace

// Launches one warp per row on `stream` and returns cudaGetLastError()
// (0 on success).  N rows (frames x limbs) of K x K candidates, K <= 128.
extern "C" int greedy_match_launch(const float* score, const uint8_t* valid,
                                   const int64_t* n_a, const int64_t* n_b,
                                   int64_t* out_a, int64_t* out_b,
                                   float* out_s, uint8_t* out_v, int N, int K,
                                   void* stream) {
  const long long smem = smem_bytes(K);
  if (N <= 0 || K <= 0 || K > 128 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const uint8_t*, const int64_t*, const int64_t*,
                 int64_t*, int64_t*, float*, uint8_t*, int) =
      K <= 32 ? greedy_match_kernel<1>
              : (K <= 64 ? greedy_match_kernel<2> : greedy_match_kernel<4>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<N, 32, (int)smem, (cudaStream_t)stream>>>(
      score, valid, n_a, n_b, out_a, out_b, out_s, out_v, K);
  return (int)cudaGetLastError();
}

extern "C" const char* greedy_match_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
