// The grouping fold for Hopper (sm_90a): a frame's accepted limb
// connections, in (limb, greedy) order, folded one at a time into a fixed
// table of person subsets.
//
// Replaces the JAX package's device loop tpupose/ops/grouping.py::
// group_keypoints (:82), an XLA while_loop over the compacted valid
// connections that detect_batch vmaps over frames (it is no Pallas kernel;
// PyTorch has no device-side loop, so the port's counterpart is this
// kernel).  Semantics are those of tpupose_torch/ops/grouping.py::
// fold_connections, bit for bit: per connection, the subsets holding either
// endpoint are counted; one -> attach joint b; two -> merge them when
// joint-disjoint (the row sum js1 + js2 + 1, the count column taking the
// connection score too, a reference quirk), else fill the missing endpoint
// in the first and then the second; none -> spawn the next slot (not for
// the non-spawning limbs; a full table counts a suppressed spawn); three or
// more -> ignore.  Every float sum rounds on its own in the plain version's
// association (__fadd_rn), and the final filter divides with __fdiv_rn.
//
// Bound: latency.  The steps are sequential (one per valid connection,
// about people x limbs: 608 in a crowd of 32 at K = 32), so neither bytes
// nor comparisons bound it: the chain of dependent steps does.  The first
// design (PR 12) read each step's slots from device memory (:117-118 of
// that source) and thread 0 its scores (:151-153), so every step waited on
// a global load; took the match count and first two rows from a
// shared-memory tree reduction with log2(threads) barriers (:133-146); and
// ran the disjoint test and the merge over 18 joints on thread 0 alone
// (:164-171) while the block waited at a barrier (:209): 1.12 us a step.
//
// This design: one warp per block, one block per frame.  Before the loop,
// the valid connections are listed in flat (limb, slot) order (the stable
// partition the plain version sorts for: a ballot and a popcount per 32
// connections) and each one's joints, slots, connection score and two peak
// scores are staged in shared memory, so the loop reads only shared memory
// and registers; every staging copy issues a lane's loads before its
// stores (one load latency, not one per element).  The table is stored by
// column (table[j * SP + s], SP = S | 1), so a lane's rows are consecutive
// words, and each lane keeps its rows' active flags in a register.  Per
// step each lane reads its created rows' two cells together (no short
// circuit), __ballot_sync gives the match masks, __popc the count and the
// first two set bits s1 and s2, the same on every lane.  An attach to one
// of the first 32 rows is done by that row's lane from the cell, score and
// count it read with the match test; lane j < J owns joint column j: the
// disjoint test is __any_sync over the lanes and the merge writes all
// columns at once; the other float updates stay on lane 0.  __syncwarp
// orders each step's shared writes before the next step's reads; there is
// no block barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#define GROUP_FOLD_MAX_LIMBS 64

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

struct Limbs {
  int from[GROUP_FOLD_MAX_LIMBS];
  int to[GROUP_FOLD_MAX_LIMBS];
  int spawns[GROUP_FOLD_MAX_LIMBS];  // 0 for the non-spawning limbs
};

struct Sizes {
  int L, K, J, KP, S;  // limbs, slots, table columns, peak slots, rows
};

// Shared memory of one block: the peak scores (J x KP, rounded up to 4
// words), the table (J x (S | 1) int32), score and count (S each), then per
// connection its flag byte (rounded up to words), its flat index in the
// listed order, and the staged joints, two slots, connection score and two
// peak scores; 32 words of slack for the match test's reads past the last
// created row.  ops/group_fold.py::smem_bytes computes the same.
long long smem_bytes(int L, int K, int J, int KP, int S) {
  const long long lk = (long long)L * K;
  return 4LL * (((long long)J * KP + 3) / 4 * 4 + (long long)J * (S | 1) +
                2LL * S + (lk + 3) / 4 + 7 * lk + 32);
}

// Copies n elements, 32 x 8 a turn: each lane issues its 8 predicated loads
// before any store, so a short copy waits on one load latency, not on one
// per element (an unrolled loop with a run-time trip count falls back to
// one load at a time for its remainder).
template <typename T>
__device__ __forceinline__ void copy_batched(T* dst, const T* src, int n,
                                             int lane) {
  for (int base = 0; base < n; base += 256) {
    T v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (base + 32 * t + lane < n) v[t] = src[base + 32 * t + lane];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (base + 32 * t + lane < n) dst[base + 32 * t + lane] = v[t];
  }
}

// One listed connection, as staged.
struct Conn {
  int j, a, b;  // ja | jb << 8 | spawns << 16; the two peak slots
  float c, pa, pb;
};

// a_slot, b_slot: (B, L, K) int64; conn_score: (B, L, K) float32;
// conn_valid: (B, L, K) uint8; peak_score: (B, J, KP) float32 (its joints
// are the table's columns); out_slot: (B, S, J) int64; out_score,
// out_count: (B, S) float32; out_valid: (B, S) uint8; out_suppressed: (B,)
// int64.
__global__ void __launch_bounds__(32) group_fold_kernel(
    const int64_t* __restrict__ a_slot, const int64_t* __restrict__ b_slot,
    const float* __restrict__ conn_score,
    const uint8_t* __restrict__ conn_valid,
    const float* __restrict__ peak_score, Limbs limbs, Sizes z,
    float limbs_thresh, float score_thresh, int64_t* out_slot,
    float* out_score, float* out_count, uint8_t* out_valid,
    int64_t* out_suppressed) {
  extern __shared__ __align__(16) int smem[];
  const int S = z.S, J = z.J, K = z.K, KP = z.KP, LK = z.L * z.K;
  const int SP = S | 1;
  float* peaks = (float*)smem;                    // J x KP, 4-rounded
  int* table = (int*)(peaks + (J * KP + 3) / 4 * 4);  // J x SP
  float* score = (float*)(table + J * SP);        // S
  float* count = score + S;                       // S
  uint8_t* flag = (uint8_t*)(count + S);          // LK, word-rounded
  int* order = (int*)(flag + 4 * ((LK + 3) / 4));  // LK
  int* st_j = order + LK;             // LK each: the staged Conn fields
  int* st_a = st_j + LK;
  int* st_b = st_a + LK;
  float* st_c = (float*)(st_b + LK);
  float* st_pa = st_c + LK;
  float* st_pb = st_pa + LK;

  const int lane = threadIdx.x;
  const long long frame = blockIdx.x;
  const long long conn0 = frame * LK;

  // 1. the validity flags and the peak scores, four a load where aligned,
  // all loads of a turn issued before its stores
  const uint8_t* g_flag = conn_valid + conn0;
  const float* g_peaks = peak_score + frame * J * KP;
  if ((LK & 3) == 0 && ((uintptr_t)g_flag & 3) == 0 && ((J * KP) & 3) == 0 &&
      ((uintptr_t)g_peaks & 15) == 0) {
    const int nf = LK / 4, np = J * KP / 4, n = nf > np ? nf : np;
    for (int base = 0; base < n; base += 256) {
      uint32_t fv[8];
      float4 pv[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = base + 32 * t + lane;
        if (i < nf) fv[t] = ((const uint32_t*)g_flag)[i];
        if (i < np) pv[t] = ((const float4*)g_peaks)[i];
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = base + 32 * t + lane;
        if (i < nf) ((uint32_t*)flag)[i] = fv[t];
        if (i < np) ((float4*)peaks)[i] = pv[t];
      }
    }
  } else {
    copy_batched(flag, g_flag, LK, lane);
    copy_batched(peaks, g_peaks, J * KP, lane);
  }
  __syncwarp();
  // 2. the valid connections in flat order: a ballot per 32 flags, four
  // chunks' ballots before their places; each lane's place from the
  // popcount of the lanes below it
  int n_valid = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < LK; base += 128) {
    unsigned m[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = base + 32 * t + lane;
      m[t] = __ballot_sync(kFull, f < LK && flag[f] != 0);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if ((m[t] >> lane) & 1u)
        order[n_valid + __popc(m[t] & below)] = base + 32 * t + lane;
      n_valid += __popc(m[t]);
    }
  }
  __syncwarp();
  // 3. each listed connection's joints, slots and scores, 32 x 8 a turn
  // (loads first, as in copy_batched)
  for (int base = 0; base < n_valid; base += 256) {
    int f[8];
    int64_t ia[8], ib[8];
    float c[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int n = base + 32 * t + lane;
      if (n < n_valid) {
        f[t] = order[n];
        ia[t] = a_slot[conn0 + f[t]];
        ib[t] = b_slot[conn0 + f[t]];
        c[t] = conn_score[conn0 + f[t]];
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int n = base + 32 * t + lane;
      if (n < n_valid) {
        const int l = f[t] / K;
        const int ja = limbs.from[l], jb = limbs.to[l];
        st_j[n] = ja | jb << 8 | limbs.spawns[l] << 16;
        st_a[n] = (int)ia[t];
        st_b[n] = (int)ib[t];
        st_c[n] = c[t];
        st_pa[n] = peaks[ja * KP + (int)ia[t]];
        st_pb[n] = peaks[jb * KP + (int)ib[t]];
      }
    }
  }
  __syncwarp();

  // 4. the fold; rows at and past `created` have never been written.  The
  // next connection is read while this one folds (the staged arrays are
  // not written again).  Bit r of `act` is row 32 r + lane's active flag.
  int created = 0, suppressed = 0;
  unsigned act = 0u;
  Conn next = {};
  if (n_valid > 0)
    next = {st_j[0], st_a[0], st_b[0], st_c[0], st_pa[0], st_pb[0]};
  for (int n = 0; n < n_valid; ++n) {
    const Conn cur = next;
    if (n + 1 < n_valid)
      next = {st_j[n + 1], st_a[n + 1], st_b[n + 1],
              st_c[n + 1], st_pa[n + 1], st_pb[n + 1]};
    const int ja = cur.j & 0xff, jb = (cur.j >> 8) & 0xff;

    // the matching rows: how many, the first two (every operand read, no
    // short circuit, so the loads go out together); the first 32 rows
    // inline, any others 32 a turn
    const int ta = table[ja * SP + lane], tb = table[jb * SP + lane];
    const float sc0 = score[lane], cn0 = count[lane];  // this lane's row
    unsigned m = __ballot_sync(kFull, (act & 1u) &
                                          ((ta == cur.a) | (tb == cur.b)));
    int cnt = __popc(m);
    int s1 = m ? __ffs(m) - 1 : kNone;
    m &= m - 1u;
    int s2 = m ? __ffs(m) - 1 : kNone;
#pragma unroll 1
    for (int base = 32; base < created; base += 32) {
      const int s = base + lane;
      const int ta_s = table[ja * SP + s], tb_s = table[jb * SP + s];
      m = __ballot_sync(kFull, ((act >> (base >> 5)) & 1u) &
                                   ((ta_s == cur.a) | (tb_s == cur.b)));
      cnt += __popc(m);
      if (m && s1 == kNone) {
        s1 = base + __ffs(m) - 1;
        m &= m - 1u;
      }
      if (m && s2 == kNone) s2 = base + __ffs(m) - 1;
    }

    if (cnt == 1 && s1 < 32) {  // the row's lane has read what it needs
      if (lane == s1 && tb != cur.b) {
        table[jb * SP + s1] = cur.b;
        count[s1] = __fadd_rn(cn0, 1.0f);
        score[s1] = __fadd_rn(sc0, __fadd_rn(cur.pb, cur.c));
      }
    } else if (cnt == 1) {
      if (lane == 0) {
        const int t = table[jb * SP + s1];
        const float c1 = count[s1], sc1 = score[s1];
        if (t != cur.b) {
          table[jb * SP + s1] = cur.b;
          count[s1] = __fadd_rn(c1, 1.0f);
          score[s1] = __fadd_rn(sc1, __fadd_rn(cur.pb, cur.c));
        }
      }
    } else if (cnt == 2) {
      int v1 = -1, v2 = -1;
      if (lane < J) {
        v1 = table[lane * SP + s1];
        v2 = table[lane * SP + s2];
      }
      if (!__any_sync(kFull, v1 >= 0 && v2 >= 0)) {  // disjoint: merge
        if (lane < J) {
          table[lane * SP + s1] = v1 + v2 + 1;
          table[lane * SP + s2] = -1;
        }
        if (lane == 0) {
          const float sc1 = score[s1], sc2 = score[s2];
          const float c1 = count[s1], c2 = count[s2];
          score[s1] = __fadd_rn(sc1, __fadd_rn(sc2, cur.c));
          count[s1] = __fadd_rn(c1, __fadd_rn(c2, cur.c));
          score[s2] = 0.0f;
          count[s2] = 0.0f;
        }
        if (lane == (s2 & 31)) act &= ~(1u << (s2 >> 5));
      } else if (lane == 0) {  // fill the missing endpoint in s1, then s2
        const int rows[2] = {s1, s2};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = rows[k];
          const int ta = table[ja * SP + r], tb = table[jb * SP + r];
          const float cr = count[r], sr = score[r];
          float add = 0.0f, inc = 0.0f;
          if (ta == -1) {
            table[ja * SP + r] = cur.a;
            add = __fadd_rn(cur.pa, cur.c);
            inc = 1.0f;
          } else if (tb == -1) {
            table[jb * SP + r] = cur.b;
            add = __fadd_rn(cur.pb, cur.c);
            inc = 1.0f;
          }
          count[r] = __fadd_rn(cr, inc);
          score[r] = __fadd_rn(sr, add);
        }
      }
    } else if (cnt == 0 && (cur.j >> 16)) {
      if (created < S) {
        if (lane < J)
          table[lane * SP + created] =
              lane == jb ? cur.b : (lane == ja ? cur.a : -1);
        if (lane == 0) {
          count[created] = 2.0f;
          score[created] = __fadd_rn(__fadd_rn(cur.pa, cur.pb), cur.c);
        }
        if (lane == (created & 31)) act |= 1u << (created >> 5);
        ++created;
      } else {
        ++suppressed;
      }
    }
    __syncwarp();
  }

  // 5. final filter (ref pose_detector.py:248) and the outputs
  for (int s = lane; s < S; s += 32) {
    const long long o = frame * S + s;
    const bool on = s < created;
    const float c = on ? count[s] : 0.0f, sc = on ? score[s] : 0.0f;
    const float safe = c < 1.0f ? 1.0f : c;  // torch.clamp: NaN stays NaN
    out_valid[o] = ((act >> (s >> 5)) & 1u) && c >= limbs_thresh &&
                   __fdiv_rn(sc, safe) >= score_thresh;
    out_score[o] = sc;
    out_count[o] = c;
  }
  if (J & 1) {
    // an odd J (BODY_25's 25 parts): the (S, J) row-major slots one a
    // store, coalesced, (s, j) of a lane's next element advanced without
    // a division; -1 past the created rows
    int64_t* slots = out_slot + frame * S * J;
    const int ds = 32 / J, dj = 32 - ds * J;
    int s = lane / J, j = lane - s * J;
    for (int i = lane; i < S * J; i += 32) {
      slots[i] = s < created ? table[j * SP + s] : -1;
      s += ds;
      j += dj;
      if (j >= J) {
        j -= J;
        ++s;
      }
    }
  } else {
    // the (S, J) row-major slots, coalesced, two a store: the created rows
    // from the table ((s, j) of a lane's next pair advanced without a
    // division), then the rest, contiguous, all -1
    longlong2* pairs = (longlong2*)(out_slot + frame * S * J);
    const int ds = 64 / J, dj = 64 - ds * J;
    int s = 2 * lane / J, j = 2 * lane - s * J;
#pragma unroll 4
    for (int i = lane; i < created * J / 2; i += 32) {
      pairs[i] = longlong2{table[j * SP + s], table[(j + 1) * SP + s]};
      s += ds;
      j += dj;
      if (j >= J) {
        j -= J;
        ++s;
      }
    }
#pragma unroll 4
    for (int i = created * J / 2 + lane; i < S * J / 2; i += 32)
      pairs[i] = longlong2{-1, -1};
  }
  if (lane == 0) out_suppressed[frame] = suppressed;
}

}  // namespace

// Launches one warp per frame on `stream` and returns cudaGetLastError()
// (0 on success).  limbs_from / limbs_to / spawns: L host ints each; J at
// most 32; out_slot 16-byte aligned; S at most 1024.
extern "C" int group_fold_launch(
    const int64_t* a_slot, const int64_t* b_slot, const float* conn_score,
    const uint8_t* conn_valid, const float* peak_score, const int* limbs_from,
    const int* limbs_to, const int* spawns, int B, int L, int K, int J,
    int KP, int S, float limbs_thresh, float score_thresh, int64_t* out_slot,
    float* out_score, float* out_count, uint8_t* out_valid,
    int64_t* out_suppressed, void* stream) {
  if (B <= 0 || L <= 0 || L > GROUP_FOLD_MAX_LIMBS || K <= 0 || J <= 0 ||
      J > 32 || KP <= 0 || S <= 0 || S > 1024 ||
      ((uintptr_t)out_slot & 15))
    return (int)cudaErrorInvalidValue;
  Limbs limbs = {};
  for (int l = 0; l < L; ++l) {
    if (limbs_from[l] < 0 || limbs_from[l] >= J || limbs_to[l] < 0 ||
        limbs_to[l] >= J)
      return (int)cudaErrorInvalidValue;
    limbs.from[l] = limbs_from[l];
    limbs.to[l] = limbs_to[l];
    limbs.spawns[l] = spawns[l] != 0;
  }
  const Sizes z = {L, K, J, KP, S};
  const long long bytes = smem_bytes(L, K, J, KP, S);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  group_fold_kernel<<<B, 32, (int)bytes, (cudaStream_t)stream>>>(
      a_slot, b_slot, conn_score, conn_valid, peak_score, limbs, z,
      limbs_thresh, score_thresh, out_slot, out_score, out_count, out_valid,
      out_suppressed);
  return (int)cudaGetLastError();
}

extern "C" const char* group_fold_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
