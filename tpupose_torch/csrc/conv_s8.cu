// int8 x int8 -> int32 k x k SAME convolution (k = 1 or 3) of 1 to 4 input
// groups with the w8a8 requantize epilogue and its activation fused, as an
// implicit GEMM on the int8 tensor cores, for Hopper (sm_90a).
//
// This is the port's redesign of the Pallas TPU kernel
// tpupose/ops/pallas/requant.py::requant_epilogue for the card: it replaces
// that epilogue on the main path by fusing it into its producer, as
// tpupose/quant.py::_qconv does under XLA (lax.conv_general_dilated with
// preferred_element_type=int32, the epilogue fused by the compiler).  It
// runs every non-head int8 layer of ksize 1 or 3 (30 per CocoPoseNet
// forward, 108 per BODY_25 forward).  Semantics are those of
// tpupose_torch/ops/conv_s8.py::conv_s8_reference, bit for bit:
//   acc_g = sum over the k x k window and the C_g channels of x_g * w_g
//           (int32, exact in any order: |acc| <= 9 * 512 * 128 * 127 <
//           2^31; zero padding outside the image)
//   y     = acc_0 * mult_0 (+ acc_1 * mult_1 ...) + bias in float32, each
//           product and sum rounded on its own in that order
//           (__fmul_rn/__fadd_rn: nvcc would otherwise contract them)
//   out   = ReLU:  clip(rint(max(y, 0)), 0, 127)
//           PReLU: clip(rint(y < 0 ? y * slope_c : y), -127, 127)
//           none:  clip(rint(y), -127, 127)          as int8.
// The int32 accumulators stay in registers and shared memory: they never
// reach device memory, and neither does an im2col patch matrix.
//
// Groups: BODY_25's dense blocks enter their next conv as the concatenation
// [_0, _1, _2], and its stages as [feature, PAF(, heatmap)], each member at
// its own scale.  Each group keeps its own int32 accumulator and is folded
// into the float32 y in group order before the next group starts, as
// conv7_s8.cu does; nothing is concatenated in device memory.  One group
// (kMulti false) is the path of CocoPoseNet and the crop nets: its K loop
// and epilogue are those of a single-group kernel; the activation is a
// runtime branch of the epilogue only, outside the K loop.
//
// GEMM: M = the block's output pixels (rows of 16), N = its 32 or 64
// output channels, K = k*k taps x C_pad (channels zero-padded to a multiple
// of 32; zero channels add exact zeros).  K is cut into units of one tap
// and 32 channels, each one k32 step of mma.sync.m16n8k32.s32.s8.s8.s32.
//
// Shared memory: the haloed NHWC input tile, (rows + 2r) x (16 + 2r)
// pixels (r = k / 2) of C_pad bytes at a pixel stride of C_pad + 16 bytes
// (an odd number of 16-byte units, so the 8 row addresses of an ldmatrix
// phase hit 8 distinct bank quads), staged once; unit (tap (dy, dx),
// chunk c)'s A fragment is that tile shifted by (dy, dx) and 32 c bytes:
// each lane hands ldmatrix its own pixel's address.  The input layer's
// C = 3 is staged with byte loads and zero fill, into C_pad = 32 (29/32 of
// each of its k32 steps multiply zeros).  The weights, packed once per
// layer as (k*k, O, C_pad) int8 (K contiguous per output channel, the B
// fragments' layout), stream through a 3-stage cp.async ring: a stage holds
// kWarpsK x 4 units of the block's channels, each channel's units in one
// row of odd 16-byte stride.
//
// Warps: kWarpsM along M (2 output rows each) and kWarpsK along K.  Warp kw
// takes units kw, kw + kWarpsK, ... of each stage, so a 1x1 128-channel
// layer still gives each of 4 K warps one unit, and 9 taps of 64 channels
// (18 units) split 5/5/4/4.  The K warps' int32 partials meet in shared
// memory (the ring's space; integer sums are exact in any order) and warp
// kw finishes the N fragments j with j % kWarpsK == kw.  With kWarpsK = 1
// each warp finishes its own fragments from registers.  Several groups run
// on the tiles with kWarpsK > 1 only: each group restages the input tile
// (at its own pixel stride, in space sized for the widest group) and its
// weights, and warp kw keeps the float32 y of its kNF / kWarpsK fragments
// in registers from group to group.
//
// Bound: at the stem's grids, tensor-core operations.  conv1_2 (64 -> 64
// at 368 x 496) is 6.73 G MAC = 13.5 G int8 operations, 6.8 us at the
// card's 1,979 TOP/s, against 23.4 MB in and out, 7.0 us at 3.35 TB/s; its
// im2col route moved some 330 MB.  mma.sync reaches about 307 T MAC/s on
// this card (scripts/conv7_mma_probe.py), 22 us for conv1_2.  Tiles
// (ops/conv_s8.py::TILES, chosen per layer by pick_tile from the
// measurements written there): 16 or 8 rows x 64 channels with one K warp
// for the big grids, which fill 132 SMs many times over and re-read the
// weights least; 8 rows x 64 channels with 2 K warps at 92x124; 4 or 8
// rows x 32 channels with the K split over 4 warps for the 46x62 layers,
// where blocks are few.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 16;        // output columns per block: one M fragment
constexpr int kUnitK = 32;        // channels (bytes) of one K unit
constexpr int kUnitsPerWarp = 4;  // units each K warp takes per ring stage
constexpr int kStages = 3;        // depth of the weight ring
constexpr int kMaxGroups = 4;     // CONV_S8_MAX_GROUPS: input groups a launch
enum { kActNone = 0, kActRelu = 1, kActPrelu = 2 };  // ops/requant.py::ACTS

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past src_bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's fragments for one unit: A for its 2 M fragments (output rows),
// B for its kNF N fragments (one ldmatrix.x4 per 16 channels).
template <int kNF>
struct Frags {
  uint32_t a[2][4];
  uint32_t b[kNF / 2][4];
};

template <int kNF>
__device__ __forceinline__ void load_frags(Frags<kNF>& f, uint32_t a_addr,
                                           uint32_t a_row_step,
                                           uint32_t b_addr,
                                           uint32_t b_pair_step) {
  ldmatrix_x4(f.a[0], a_addr);
  ldmatrix_x4(f.a[1], a_addr + a_row_step);
#pragma unroll
  for (int q = 0; q < kNF / 2; ++q) ldmatrix_x4(f.b[q], b_addr + q * b_pair_step);
}

template <int kNF>
__device__ __forceinline__ void mma_frags(int (&acc)[2][kNF][4],
                                          const Frags<kNF>& f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      mma_s8(acc[i][j], f.a[i], f.b[j / 2][(j % 2) * 2],
             f.b[j / 2][(j % 2) * 2 + 1]);
    }
  }
}

// The epilogue of one output: y (the groups' scaled sums, in group order)
// + bias, the activation, rint, the clip.  act: kActNone (store in
// [-127, 127]), kActRelu (max(v, 0), store in [0, 127]) or kActPrelu
// (v < 0 ? v * slope : v, store in [-127, 127]).
__device__ __forceinline__ int8_t finish(float y, float bias, float slope,
                                         int act) {
  float v = __fadd_rn(y, bias);
  float lo = -127.0f;
  if (act == kActRelu) {
    v = fmaxf(v, 0.0f);
    lo = 0.0f;
  } else if (act == kActPrelu && v < 0.0f) {
    v = __fmul_rn(v, slope);
  }
  v = fminf(fmaxf(rintf(v), lo), 127.0f);
  return (int8_t)(int)v;
}

// A block of kWarpsM x kWarpsK warps, kTileH = 2 kWarpsM output rows of 16
// columns, kTileN = 8 kNF output channels.
template <int kWarpsM, int kWarpsK, int kNF>
struct Tile {
  static constexpr int kTileH = 2 * kWarpsM;
  static constexpr int kTileN = 8 * kNF;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsK;
  static constexpr int kStageUnits = kWarpsK * kUnitsPerWarp;
  // One channel's row of a ring stage: its kStageUnits units, then 16 bytes
  // (an odd number of 16-byte units per row).
  static constexpr int kRowStride = kStageUnits * kUnitK + 16;
  static constexpr int kStageBytes = kTileN * kRowStride;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartialBytes =
      kWarpsK > 1 ? kWarpsK * kWarpsM * 2 * kNF * 4 * 32 * 4 : 0;
  // The ring, or the partial sums that reuse its space.
  static constexpr int kMidBytes =
      kRingBytes > kPartialBytes ? kRingBytes : kPartialBytes;
};

// The input groups of one launch (by value, in the kernel's parameters).
struct Groups {
  const int8_t* x[kMaxGroups];
  const int8_t* w[kMaxGroups];
  const float* mult[kMaxGroups];
  int c[kMaxGroups];
  int c_pad[kMaxGroups];
};

// Fragment (i, j)'s y, element e = pixel column lane / 4 + 8 (e / 2),
// channel 8 j + 2 (lane % 4) + e % 2: sum * mult in float32.
__device__ __forceinline__ void scale_fragment(const int (&sum)[2][4],
                                               const float* __restrict__ mult,
                                               int n, float (&y)[2][4]) {
  const float m0 = __ldg(mult + n);
  const float m1 = __ldg(mult + n + 1);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[i][e] = __fmul_rn(__int2float_rn(sum[i][e]), e % 2 ? m1 : m0);
}

__device__ __forceinline__ void store_fragment(
    const float (&y)[2][4], int j, int8_t* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ slope, int b,
    int H, int W, int O, int act, int row0, int tx0, int n0, int lane) {
  const int n = n0 + 8 * j + 2 * (lane % 4);
  const float b0 = __ldg(bias + n);
  const float b1 = __ldg(bias + n + 1);
  const float s0 = act == kActPrelu ? __ldg(slope + n) : 0.0f;
  const float s1 = act == kActPrelu ? __ldg(slope + n + 1) : 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = row0 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = tx0 + lane / 4 + 8 * h;
      if (gy >= H || gx >= W) continue;
      char2 v;
      v.x = finish(y[i][2 * h], b0, s0, act);
      v.y = finish(y[i][2 * h + 1], b1, s1, act);
      *reinterpret_cast<char2*>(out + (((size_t)b * H + gy) * W + gx) * O +
                                n) = v;
    }
  }
}

// One group's int32 sums of the block's tile into `acc`: its unit offsets,
// its haloed input tile and its weights through the ring, the K loop.
// Warp (wm, kw) sums output rows 2 wm, 2 wm + 1 of the tile (16 columns
// each) and all kTileN channels of the block over its units.  Ends with
// every copy landed; the caller syncs before it reuses the ring.
template <int kWarpsM, int kWarpsK, int kNF>
__device__ __forceinline__ void group_sums(
    int (&acc)[2][kNF][4], const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, int H, int W, int C, int c_pad, int O,
    int k, int ty0, int tx0, int n0, int8_t* a_tile, int8_t* ring,
    int* a_off, int warp_m, int kw, int lane) {
  using T = Tile<kWarpsM, kWarpsK, kNF>;
  constexpr int kThreads = T::kThreads;
  const int r = k / 2;
  const int in_w = kTileW + 2 * r;
  const int in_h = T::kTileH + 2 * r;
  const int stride = c_pad + 16;
  const int chunks = c_pad / kUnitK;
  const int units = k * k * chunks;

  // Unit u = tap * chunks + c: its A fragment's offset in the tile.
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int tap = u / chunks;
    const int c = u - tap * chunks;
    const int dy = tap / k;
    const int dx = tap - dy * k;
    a_off[u] = (dy * in_w + dx) * stride + c * kUnitK;
  }

  // The haloed input tile: pixel (ly, lx) is image pixel
  // (ty0 - r + ly, tx0 - r + lx), zero outside the image and past C.
  if (C % 16 == 0) {
    const int pieces = c_pad / 16;
    for (int i = threadIdx.x; i < in_h * in_w * pieces; i += kThreads) {
      const int p = i / pieces;
      const int q = i - p * pieces;
      const int gy = ty0 - r + p / in_w;
      const int gx = tx0 - r + p % in_w;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && q * 16 < C;
      const int8_t* src = in ? x + ((size_t)gy * W + gx) * C + q * 16 : x;
      cp_async16(smem_addr(a_tile + p * stride + q * 16), src, in ? 16 : 0);
    }
  } else {
    const int words = c_pad / 4;
    for (int i = threadIdx.x; i < in_h * in_w * words; i += kThreads) {
      const int p = i / words;
      const int q = i - p * words;
      const int gy = ty0 - r + p / in_w;
      const int gx = tx0 - r + p % in_w;
      uint32_t word = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int8_t* px = x + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = 4 * q + j;
          if (ch < C) word |= (uint32_t)(uint8_t)px[ch] << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(a_tile + p * stride + q * 4) = word;
    }
  }

  // Stage `step`'s units (kStageUnits of them, those below `units`), this
  // block's channels, into ring slot `slot`: unit j of the stage at byte
  // 32 j of each channel's row.
  auto load_step = [&](int step, int slot) {
    const int u0 = step * T::kStageUnits;
    const int n_units = min(T::kStageUnits, units - u0);
    const int per_row = 2 * n_units;  // 16-byte pieces
    int8_t* dst = ring + slot * T::kStageBytes;
    for (int i = threadIdx.x; i < T::kTileN * per_row; i += kThreads) {
      const int row = i / per_row;
      const int piece = i - row * per_row;
      const int u = u0 + piece / 2;
      const int tap = u / chunks;
      const int c = u - tap * chunks;
      const int8_t* src = w + ((size_t)tap * O + n0 + row) * c_pad +
                          c * kUnitK + (piece % 2) * 16;
      cp_async16(smem_addr(dst + row * T::kRowStride + piece * 16), src, 16);
    }
  };
  const int steps = (units + T::kStageUnits - 1) / T::kStageUnits;
  // The first commit group also carries the input tile's copies.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses.  A: lane l reads output pixel column l % 16,
  // K bytes (l / 16) * 16 .. +15 (matrices: rows 0-7 | 8-15 x k 0-15 |
  // 16-31 = a0..a3).  B: lane l reads channel (l / 16) * 8 + l % 8, K bytes
  // ((l / 8) % 2) * 16 .. +15 (b0, b1 of two N fragments).
  const uint32_t a_lane =
      smem_addr(a_tile) +
      (uint32_t)((warp_m * 2 * in_w + lane % 16) * stride + (lane / 16) * 16);
  const uint32_t b_lane =
      smem_addr(ring) +
      (uint32_t)(((lane / 16) * 8 + lane % 8) * T::kRowStride +
                 ((lane / 8) % 2) * 16);
  const uint32_t a_row_step = (uint32_t)(in_w * stride);
  const uint32_t b_pair_step = (uint32_t)(16 * T::kRowStride);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // step `step` (and the tile) landed
    __syncthreads();               // and every warp is done with step - 1
    if (step + kStages - 1 < steps)
      load_step(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();

    // This warp's units of the stage: j = d kWarpsK + kw, d < nd.
    const int u0 = step * T::kStageUnits;
    const int left = units - u0 - kw;
    const int nd = left <= 0 ? 0
                             : min(kUnitsPerWarp,
                                   (left + kWarpsK - 1) / kWarpsK);
    if (nd == 0) continue;
    const uint32_t b_stage = b_lane + (step % kStages) * T::kStageBytes;
    // Two fragment buffers: the next unit loads while this one's MMAs run.
    Frags<kNF> f0, f1;
    load_frags(f0, a_lane + a_off[u0 + kw], a_row_step, b_stage + kw * kUnitK,
               b_pair_step);
#pragma unroll
    for (int d = 0; d < kUnitsPerWarp; d += 2) {
      if (d + 1 < nd) {
        const int j = (d + 1) * kWarpsK + kw;
        load_frags(f1, a_lane + a_off[u0 + j], a_row_step,
                   b_stage + j * kUnitK, b_pair_step);
      }
      mma_frags(acc, f0);
      if (d + 1 >= nd) break;
      if (d + 2 < nd) {
        const int j = (d + 2) * kWarpsK + kw;
        load_frags(f0, a_lane + a_off[u0 + j], a_row_step,
                   b_stage + j * kUnitK, b_pair_step);
      }
      mma_frags(acc, f1);
      if (d + 2 >= nd) break;
    }
  }
  cp_async_wait<0>();
}

// The K warps' partial sums of fragment j (kWarpsK > 1), after they were
// written to `partial`: partial[kw][warp_m][i][j][e][lane], lanes
// contiguous.
template <int kWarpsM, int kWarpsK, int kNF>
__device__ __forceinline__ void write_partials(const int (&acc)[2][kNF][4],
                                               int* partial, int warp_m,
                                               int kw, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        partial[((((kw * kWarpsM + warp_m) * 2 + i) * kNF + j) * 4 + e) *
                    32 + lane] = acc[i][j][e];
}

template <int kWarpsM, int kWarpsK, int kNF>
__device__ __forceinline__ void sum_partials(const int* partial, int j,
                                             int warp_m, int lane,
                                             int (&sum)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int s = 0;
#pragma unroll
      for (int q = 0; q < kWarpsK; ++q)
        s += partial[((((q * kWarpsM + warp_m) * 2 + i) * kNF + j) * 4 + e) *
                         32 + lane];
      sum[i][e] = s;
    }
  }
}

// One input group (kMulti false: every CocoPoseNet and crop-net layer, and
// BODY_25's single-input convs) or 1 to kMaxGroups groups (kMulti), each
// with its own int32 sums folded into the float32 y in group order.  With
// kMulti the K warps always meet in shared memory, and warp kw keeps the y
// of its kNF / kWarpsK fragments j = kw, kw + kWarpsK, ... in registers
// across the groups.  `tile_bytes`: the input tile's space, sized for the
// widest group.
template <int kWarpsM, int kWarpsK, int kNF, bool kMulti>
__global__ void __launch_bounds__(Tile<kWarpsM, kWarpsK, kNF>::kThreads)
conv_s8_kernel(Groups groups, int G, const float* __restrict__ bias,
               const float* __restrict__ slope, int8_t* __restrict__ out,
               int H, int W, int O, int k, int act, int tiles_w,
               int tile_bytes) {
  using T = Tile<kWarpsM, kWarpsK, kNF>;
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* a_tile = smem;
  int8_t* ring = smem + tile_bytes;
  int* partial = reinterpret_cast<int*>(ring);
  int* a_off = reinterpret_cast<int*>(ring + T::kMidBytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_m = warp % kWarpsM;
  const int kw = warp / kWarpsM;
  const int ty0 = (blockIdx.x / tiles_w) * T::kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * T::kTileN;
  const int b = blockIdx.z;
  const int row0 = ty0 + warp_m * 2;
  const int lane_n = 2 * (lane % 4);  // + n0 + 8 j: fragment j's channel

  if constexpr (!kMulti) {
    const int C = groups.c[0];
    int acc[2][kNF][4];
    group_sums<kWarpsM, kWarpsK, kNF>(
        acc, groups.x[0] + (size_t)b * H * W * C, groups.w[0], H, W, C,
        groups.c_pad[0], O, k, ty0, tx0, n0, a_tile, ring, a_off, warp_m, kw,
        lane);
    const float* mult = groups.mult[0];
    if constexpr (kWarpsK == 1) {
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        int sum[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][e] = acc[i][j][e];
        float y[2][4];
        scale_fragment(sum, mult, n0 + 8 * j + lane_n, y);
        store_fragment(y, j, out, bias, slope, b, H, W, O, act, row0, tx0,
                       n0, lane);
      }
    } else {
      __syncthreads();  // the ring is free: it takes the partial sums
      write_partials<kWarpsM, kWarpsK, kNF>(acc, partial, warp_m, kw, lane);
      __syncthreads();
      // Warp kw sums its N fragments over the K warps' partials.
      for (int j = kw; j < kNF; j += kWarpsK) {
        int sum[2][4];
        sum_partials<kWarpsM, kWarpsK, kNF>(partial, j, warp_m, lane, sum);
        float y[2][4];
        scale_fragment(sum, mult, n0 + 8 * j + lane_n, y);
        store_fragment(y, j, out, bias, slope, b, H, W, O, act, row0, tx0,
                       n0, lane);
      }
    }
  } else {
    static_assert(kWarpsK > 1 && kNF % kWarpsK == 0,
                  "grouped tiles split the N fragments over the K warps");
    constexpr int kOwn = kNF / kWarpsK;
    float y[kOwn][2][4];
    for (int g = 0; g < G; ++g) {
      const int C = groups.c[g];
      int acc[2][kNF][4];
      group_sums<kWarpsM, kWarpsK, kNF>(
          acc, groups.x[g] + (size_t)b * H * W * C, groups.w[g], H, W, C,
          groups.c_pad[g], O, k, ty0, tx0, n0, a_tile, ring, a_off, warp_m,
          kw, lane);
      __syncthreads();  // the ring is free: it takes the partial sums
      write_partials<kWarpsM, kWarpsK, kNF>(acc, partial, warp_m, kw, lane);
      __syncthreads();
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int j = kw + o * kWarpsK;
        int sum[2][4];
        sum_partials<kWarpsM, kWarpsK, kNF>(partial, j, warp_m, lane, sum);
        float part[2][4];
        scale_fragment(sum, groups.mult[g], n0 + 8 * j + lane_n, part);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[o][i][e] = g == 0 ? part[i][e] : __fadd_rn(y[o][i][e],
                                                         part[i][e]);
      }
      __syncthreads();  // the next group restages the tile and the ring
    }
#pragma unroll
    for (int o = 0; o < kOwn; ++o)
      store_fragment(y[o], kw + o * kWarpsK, out, bias, slope, b, H, W, O,
                     act, row0, tx0, n0, lane);
  }
}

template <int kWarpsM, int kWarpsK, int kNF, bool kMulti>
int launch(const Groups& groups, int G, const float* bias,
           const float* slope, int8_t* out, int B, int H, int W, int O, int k,
           int act, cudaStream_t stream) {
  using T = Tile<kWarpsM, kWarpsK, kNF>;
  if (O % T::kTileN != 0) return (int)cudaErrorInvalidValue;
  // tpupose_torch/ops/conv_s8.py::smem_bytes computes the same budget: the
  // haloed input tile at the widest group's pixel stride, the ring (or the
  // partial sums), then one int per K unit of the widest group.
  int max_cp = 0;
  for (int g = 0; g < G; ++g)
    if (groups.c_pad[g] > max_cp) max_cp = groups.c_pad[g];
  const int r = k / 2;
  const int tile_bytes =
      (T::kTileH + 2 * r) * (kTileW + 2 * r) * (max_cp + 16);
  const int smem =
      tile_bytes + T::kMidBytes + 4 * (k * k * max_cp / kUnitK);
  auto kernel = conv_s8_kernel<kWarpsM, kWarpsK, kNF, kMulti>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + T::kTileH - 1) / T::kTileH;
  const dim3 grid(tiles_w * tiles_h, O / T::kTileN, B);
  kernel<<<grid, T::kThreads, smem, stream>>>(
      groups, G, bias, slope, out, H, W, O, k, act, tiles_w, tile_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xs, ws, mults: G device pointers each (host arrays), to (B, H, W, c_g)
// int8, (k*k, O, c_pad_g) int8 and (O,) float32; channels, c_pads: G ints
// each (c_pad_g a multiple of 32 and at least c_g); bias: (O,) float32;
// slope: (O,) float32 for act 2, else unused; out: (B, H, W, O) int8.  k
// is 1 or 3; act 0 (none), 1 (ReLU) or 2 (PReLU).  `tile` indexes
// ops/conv_s8.py::TILES (rows, K warps, channels): 0 = (4, 4, 32),
// 1 = (8, 4, 32), 2 = (8, 2, 64), 3 = (8, 1, 64), 4 = (16, 1, 64); O must
// be a multiple of the tile's channels.  More than one group takes tiles
// 0 to 2 only.
extern "C" int conv_s8_launch(const void* const* xs, const void* const* ws,
                              const void* const* mults, const int* channels,
                              const int* c_pads, int G, const void* bias,
                              const void* slope, void* out, int B, int H,
                              int W, int O, int k, int act, int tile,
                              void* stream) {
  if (G < 1 || G > kMaxGroups || B <= 0 || B > 65535 || H <= 0 || W <= 0 ||
      O <= 0 || (k != 1 && k != 3) || act < kActNone || act > kActPrelu ||
      (act == kActPrelu && slope == nullptr))
    return (int)cudaErrorInvalidValue;
  Groups groups = {};
  for (int g = 0; g < G; ++g) {
    if (channels[g] <= 0 || c_pads[g] % kUnitK != 0 ||
        c_pads[g] < channels[g])
      return (int)cudaErrorInvalidValue;
    groups.x[g] = (const int8_t*)xs[g];
    groups.w[g] = (const int8_t*)ws[g];
    groups.mult[g] = (const float*)mults[g];
    groups.c[g] = channels[g];
    groups.c_pad[g] = c_pads[g];
  }
  const float* bs = (const float*)bias;
  const float* sl = (const float*)slope;
  int8_t* o = (int8_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (G == 1) {
    switch (tile) {
      case 0: return launch<2, 4, 4, false>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
      case 1: return launch<4, 4, 4, false>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
      case 2: return launch<4, 2, 8, false>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
      case 3: return launch<4, 1, 8, false>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
      case 4: return launch<8, 1, 8, false>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (tile) {
    case 0: return launch<2, 4, 4, true>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
    case 1: return launch<4, 4, 4, true>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
    case 2: return launch<4, 2, 8, true>(groups, G, bs, sl, o, B, H, W, O, k, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* conv_s8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
