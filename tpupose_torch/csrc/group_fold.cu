// The grouping fold for Hopper (sm_90a): a frame's accepted limb
// connections, in (limb, greedy) order, folded one at a time into a fixed
// table of person subsets.
//
// Replaces the JAX package's device loop tpupose/ops/grouping.py::
// group_keypoints, an XLA while_loop over the compacted valid connections
// that detect_batch vmaps over frames (it is no Pallas kernel; PyTorch has
// no device-side loop, so the port's counterpart is this kernel).
// Semantics are those of tpupose_torch/ops/grouping.py::fold_connections,
// bit for bit: per connection, the subsets holding either endpoint are
// counted; one -> attach joint b; two -> merge them when joint-disjoint
// (the row sum js1 + js2 + 1, the count column taking the connection score
// too, a reference quirk), else fill the missing endpoint in the first and
// then the second; none -> spawn the next slot (not for the non-spawning
// limbs; a full table counts a suppressed spawn); three or more -> ignore.
// Every float sum rounds on its own in the plain version's association
// (__fadd_rn), and the final filter divides with __fdiv_rn.
//
// Grid: one block per frame; a power-of-two block of at least S threads (up
// to 1024, rows strided beyond).  The table (S x J int32), scores, counts
// and the active flags live in shared memory.  The block first lists the
// valid connections in flat (limb, slot) order, one thread per limb row;
// that is the stable partition the plain version sorts for.  Per
// connection every thread tests its rows for a match, a shared-memory tree
// reduction gives the count and the first two matching rows, and thread 0
// applies the case.  Bound: latency: the steps are sequential (one per
// valid connection, ~people x limbs), each log2(threads) + 2 barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#define GROUP_FOLD_MAX_LIMBS 64

namespace {

constexpr int kNone = 0x7fffffff;

struct Limbs {
  int from[GROUP_FOLD_MAX_LIMBS];
  int to[GROUP_FOLD_MAX_LIMBS];
  int spawns[GROUP_FOLD_MAX_LIMBS];  // 0 for the non-spawning limbs
};

struct Sizes {
  int L, K, J, KP, S, threads;  // limbs, slots, table columns, peak slots
};

// a_slot, b_slot: (B, L, K) int64; conn_score: (B, L, K) float32;
// conn_valid: (B, L, K) uint8; peak_score: (B, J, KP) float32 (its joints
// are the table's columns); out_slot: (B, S, J) int64; out_score,
// out_count: (B, S) float32; out_valid: (B, S) uint8; out_suppressed: (B,)
// int64.
__global__ void group_fold_kernel(
    const int64_t* __restrict__ a_slot, const int64_t* __restrict__ b_slot,
    const float* __restrict__ conn_score,
    const uint8_t* __restrict__ conn_valid,
    const float* __restrict__ peak_score, Limbs limbs, Sizes z,
    float limbs_thresh, float score_thresh, int64_t* out_slot,
    float* out_score, float* out_count, uint8_t* out_valid,
    int64_t* out_suppressed) {
  extern __shared__ __align__(16) int smem[];
  const int S = z.S, J = z.J, K = z.K, L = z.L, nt = z.threads;
  int* table = smem;                        // S x J
  float* score = (float*)(table + S * J);   // S
  float* count = score + S;                 // S
  int* active = (int*)(count + S);          // S
  int* order = active + S;                  // L x K
  int* row_n = order + L * K;               // L
  int* red_n = row_n + L;                   // nt
  int* red_1 = red_n + nt;                  // nt
  int* red_2 = red_1 + nt;                  // nt
  int* scalars = red_2 + nt;  // n_valid, n_created, n_suppressed

  const int t = threadIdx.x;
  const long long frame = blockIdx.x;
  const long long conn0 = frame * L * K;
  const float* peaks = peak_score + frame * J * z.KP;

  for (int i = t; i < S * J; i += nt) table[i] = -1;
  for (int s = t; s < S; s += nt) {
    score[s] = 0.0f;
    count[s] = 0.0f;
    active[s] = 0;
  }
  // the valid connections in flat order: count per limb row, offsets,
  // then each row's indices at its offset
  for (int l = t; l < L; l += nt) {
    int n = 0;
    for (int c = 0; c < K; ++c) n += conn_valid[conn0 + l * K + c] != 0;
    row_n[l] = n;
  }
  __syncthreads();
  if (t == 0) {
    int total = 0;
    for (int l = 0; l < L; ++l) {
      const int n = row_n[l];
      row_n[l] = total;
      total += n;
    }
    scalars[0] = total;
    scalars[1] = 0;
    scalars[2] = 0;
  }
  __syncthreads();
  for (int l = t; l < L; l += nt) {
    int at = row_n[l];
    for (int c = 0; c < K; ++c)
      if (conn_valid[conn0 + l * K + c]) order[at++] = l * K + c;
  }
  __syncthreads();

  const int n_valid = scalars[0];
  for (int step = 0; step < n_valid; ++step) {
    const int idx = order[step];
    const int l = idx / K;
    const int ja = limbs.from[l], jb = limbs.to[l];
    const int ind_a = (int)a_slot[conn0 + idx];
    const int ind_b = (int)b_slot[conn0 + idx];

    // this thread's matching rows: how many, the first two
    int n = 0, first = kNone, second = kNone;
    for (int s = t; s < S; s += nt) {
      if (active[s] &&
          (table[s * J + ja] == ind_a || table[s * J + jb] == ind_b)) {
        ++n;
        if (first == kNone) first = s;
        else if (second == kNone) second = s;
      }
    }
    red_n[t] = n;
    red_1[t] = first;
    red_2[t] = second;
    __syncthreads();
    for (int w = nt / 2; w > 0; w >>= 1) {
      if (t < w) {
        const int f1 = red_1[t], s1 = red_2[t];
        const int f2 = red_1[t + w], s2 = red_2[t + w];
        red_n[t] += red_n[t + w];
        if (f1 < f2) {
          red_2[t] = s1 < f2 ? s1 : f2;
        } else {
          red_1[t] = f2;
          red_2[t] = f1 < s2 ? f1 : s2;
        }
      }
      __syncthreads();
    }

    if (t == 0) {
      const int cnt = red_n[0], s1 = red_1[0], s2 = red_2[0];
      const float conn = conn_score[conn0 + idx];
      const float pa = peaks[ja * z.KP + ind_a];
      const float pb = peaks[jb * z.KP + ind_b];
      if (cnt == 1) {
        int* r1 = table + s1 * J;
        if (r1[jb] != ind_b) {
          r1[jb] = ind_b;
          count[s1] = __fadd_rn(count[s1], 1.0f);
          score[s1] = __fadd_rn(score[s1], __fadd_rn(pb, conn));
        }
      } else if (cnt == 2) {
        int* r1 = table + s1 * J;
        int* r2 = table + s2 * J;
        bool disjoint = true;
        for (int j = 0; j < J; ++j)
          if (r1[j] >= 0 && r2[j] >= 0) disjoint = false;
        if (disjoint) {
          for (int j = 0; j < J; ++j) {
            r1[j] = r1[j] + r2[j] + 1;
            r2[j] = -1;
          }
          score[s1] = __fadd_rn(score[s1], __fadd_rn(score[s2], conn));
          count[s1] = __fadd_rn(count[s1], __fadd_rn(count[s2], conn));
          score[s2] = 0.0f;
          count[s2] = 0.0f;
          active[s2] = 0;
        } else {
          const int rows[2] = {s1, s2};
          for (int k = 0; k < 2; ++k) {
            int* r = table + rows[k] * J;
            float add = 0.0f, inc = 0.0f;
            if (r[ja] == -1) {
              r[ja] = ind_a;
              add = __fadd_rn(pa, conn);
              inc = 1.0f;
            } else if (r[jb] == -1) {
              r[jb] = ind_b;
              add = __fadd_rn(pb, conn);
              inc = 1.0f;
            }
            count[rows[k]] = __fadd_rn(count[rows[k]], inc);
            score[rows[k]] = __fadd_rn(score[rows[k]], add);
          }
        }
      } else if (cnt == 0 && limbs.spawns[l]) {
        const int slot = scalars[1];
        if (slot < S) {
          table[slot * J + ja] = ind_a;
          table[slot * J + jb] = ind_b;
          count[slot] = 2.0f;
          score[slot] = __fadd_rn(__fadd_rn(pa, pb), conn);
          active[slot] = 1;
          scalars[1] = slot + 1;
        } else {
          scalars[2] += 1;
        }
      }
    }
    __syncthreads();
  }

  // final filter (ref pose_detector.py:248) and the outputs
  for (int s = t; s < S; s += nt) {
    const long long o = frame * S + s;
    const float c = count[s];
    const float safe = c < 1.0f ? 1.0f : c;  // torch.clamp: NaN stays NaN
    out_valid[o] = active[s] && c >= limbs_thresh &&
                   __fdiv_rn(score[s], safe) >= score_thresh;
    out_score[o] = score[s];
    out_count[o] = c;
  }
  for (int i = t; i < S * J; i += nt) out_slot[frame * S * J + i] = table[i];
  if (t == 0) out_suppressed[frame] = scalars[2];
}

}  // namespace

// Launches one block per frame on `stream` and returns cudaGetLastError()
// (0 on success).  limbs_from / limbs_to / spawns: L host ints each.
extern "C" int group_fold_launch(
    const int64_t* a_slot, const int64_t* b_slot, const float* conn_score,
    const uint8_t* conn_valid, const float* peak_score, const int* limbs_from,
    const int* limbs_to, const int* spawns, int B, int L, int K, int J,
    int KP, int S, float limbs_thresh, float score_thresh, int64_t* out_slot,
    float* out_score, float* out_count, uint8_t* out_valid,
    int64_t* out_suppressed, void* stream) {
  if (B <= 0 || L <= 0 || L > GROUP_FOLD_MAX_LIMBS || K <= 0 || J <= 0 ||
      KP <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  Limbs limbs = {};
  for (int l = 0; l < L; ++l) {
    if (limbs_from[l] < 0 || limbs_from[l] >= J || limbs_to[l] < 0 ||
        limbs_to[l] >= J)
      return (int)cudaErrorInvalidValue;
    limbs.from[l] = limbs_from[l];
    limbs.to[l] = limbs_to[l];
    limbs.spawns[l] = spawns[l];
  }
  int threads = 32;
  while (threads < S && threads < 1024) threads *= 2;
  const Sizes z = {L, K, J, KP, S, threads};
  // table, score, count, active, order, row offsets, 3 reduction arrays,
  // scalars
  const long long bytes =
      4LL * ((long long)S * J + 3LL * S + (long long)L * K + L +
             3LL * threads + 4);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  group_fold_kernel<<<B, threads, (int)bytes, (cudaStream_t)stream>>>(
      a_slot, b_slot, conn_score, conn_valid, peak_score, limbs, z,
      limbs_thresh, score_thresh, out_slot, out_score, out_count, out_valid,
      out_suppressed);
  return (int)cudaGetLastError();
}

extern "C" const char* group_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
