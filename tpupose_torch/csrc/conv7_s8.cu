// int8 x int8 -> int32 7x7 SAME convolution over G input groups with the
// w8a8 epilogue fused, as an implicit GEMM on the int8 tensor cores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpupose/ops/pallas/conv7.py::conv7_s8 (with
// its body _make_kernel).  Semantics are those of tpupose_torch/ops/conv7.py::
// conv7_s8_reference, bit for bit:
//   acc_g = sum over the 7x7 window and the C_g channels of x_g * w_g (int32,
//           exact in any order: |acc| <= 49 * 128 * 127 * 128 < 2^31; zero
//           padding outside the image)
//   y     = acc_0 * mult_0 (+ acc_1 * mult_1 ...) + bias, in float32, each
//           product and sum rounded on its own in that order
//           (__fmul_rn/__fadd_rn: nvcc would otherwise contract to FMAs)
//   out   = clip(rint(max(y, 0)), 0, 127) as int8 (max only with `relu`).
//
// GEMM: per group, M = the block's output pixels (4 or 8 rows of 16),
// N = its 32 output channels, K = 49 taps x C_pad (channels zero-padded to
// a multiple of 32, so each K step is one k32 of
// mma.sync.m16n8k32.s32.s8.s8.s32; zero channels add exact zeros).  Each
// group keeps its own int32 accumulator and is folded into the float32 sum
// in group order before the next group starts: the groups' K loops are not
// concatenated.
//
// Shared memory: the group's haloed NHWC input tile, (rows + 6) x (16 + 6)
// pixels of C_pad bytes at a pixel stride of C_pad + 16 bytes (an odd
// number of 16-byte units, so the 8 row addresses of an ldmatrix phase hit
// 8 distinct bank quads), is staged once per group; tap (dy, dx)'s A
// fragment is that tile shifted by (dy, dx): each lane hands ldmatrix the
// 16-byte-aligned address of its own pixel, and no im2col is built.  Groups
// whose channel count is not a multiple of 16 (Mconv1's 38 and 19) are
// staged with byte loads and zero fill; their tiles are small.  The
// weights, packed once per layer as (49, O, C_pad) int8 (K contiguous per
// output channel, the B fragments' layout), stream through a 3-stage
// cp.async ring, 4 taps per stage.
//
// Warps: 2 output rows each along M, and 4 along K.  Warp kw takes taps
// kw, kw + 4, ..., so each SM runs 4 warps per M slot on the same tile; at
// the end of a group the four int32 partials meet in shared memory (the
// ring's space; integer sums are exact in any order), and warp kw folds and
// finishes N fragment kw.  The epilogue reads the accumulators from
// registers and shared memory: the int32 tensor never reaches device memory.
//
// Bound: tensor-core operations.  A 128 -> 128 layer at a 46x62 grid is
// 2852 x 128 x 6272 = 2.29 G MAC = 4.58 G int8 operations, 2.3 us at the
// card's 1,979 TOP/s; its bytes (0.37 MB in, 0.8 MB weights, 0.37 MB out)
// take 0.46 us at 3.35 TB/s.  mma.sync does not reach that peak on Hopper
// (only wgmma runs the tensor cores at their full rate):
// scripts/conv7_mma_probe.py times this kernel with its loads, barriers and
// ldmatrix taken out, which gives the rate mma.sync alone reaches here.
//
// Filling 132 SMs at B = 1: 2852 output pixels are 23 blocks of 128 x 128.
// Blocks here are 32 channels wide (a block re-reads only the small input
// tile per N block, while every spatial tile re-reads all the layer's
// weights from L2), and the tap split gives each block 16 (8 rows) or 8
// (4 rows) warps, so one block per SM keeps 2-4 warps on each of its
// tensor-core quarters.  Measured by chip_smoke.py on an H100 (CUDA-graph
// replays, 128 -> 128): 8-row tiles win from 46x62 up (96 blocks there;
// 21.1 us against 23.6 for 4 rows), 4-row tiles below (15.4 us at 23x31,
// 48 blocks, against 19.9 for 8 rows).  ops/conv7.py::pick_tile encodes
// that choice.

#include <cuda_runtime.h>
#include <stdint.h>

#define CONV7_MAX_GROUPS 4

namespace {

constexpr int kTileW = 16;        // output columns per block: one M fragment
constexpr int kInW = kTileW + 6;  // haloed input columns
constexpr int kTileN = 32;        // output channels per block
constexpr int kTaps = 49;
constexpr int kTapsPerStep = 4;   // warps along K: one tap each per step
constexpr int kSteps = (kTaps + kTapsPerStep - 1) / kTapsPerStep;  // 13
constexpr int kStages = 3;        // depth of the weight ring, in steps

struct Groups {
  const int8_t* x[CONV7_MAX_GROUPS];    // (B, H, W, c) int8
  const int8_t* w[CONV7_MAX_GROUPS];    // (49, O, c_pad) int8
  const float* mult[CONV7_MAX_GROUPS];  // (O,) float32
  int c[CONV7_MAX_GROUPS];              // channels
  int c_pad[CONV7_MAX_GROUPS];          // channels padded to a multiple of 32
};

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

// One warp's fragments for one k32 step: A for its 2 M fragments (output
// rows), B for its 4 N fragments (two ldmatrix.x4, 16 channels each).
struct Frags {
  uint32_t a[2][4];
  uint32_t b[2][4];
};

__device__ __forceinline__ void load_frags(Frags& f, uint32_t a_addr,
                                           uint32_t a_row_step,
                                           uint32_t b_addr,
                                           uint32_t b_half_step) {
  ldmatrix_x4(f.a[0], a_addr);
  ldmatrix_x4(f.a[1], a_addr + a_row_step);
  ldmatrix_x4(f.b[0], b_addr);
  ldmatrix_x4(f.b[1], b_addr + b_half_step);
}

__device__ __forceinline__ void mma_frags(int (&acc)[2][4][4],
                                          const Frags& f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_s8(acc[i][j], f.a[i], f.b[j / 2][(j % 2) * 2],
             f.b[j / 2][(j % 2) * 2 + 1]);
    }
  }
}

__device__ __forceinline__ int8_t finish(float y, float bias, int relu) {
  float v = __fadd_rn(y, bias);
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), 0.0f), 127.0f);
  return (int8_t)(int)v;
}

// Shared memory of a block with kWarpsM warps along M at a pixel stride of
// `stride` bytes: the haloed input tile, then the weight ring, which the
// cross-warp reduction reuses once a group's K loop is done.
template <int kWarpsM>
__host__ __device__ constexpr int tile_bytes(int stride) {
  return (2 * kWarpsM + 6) * kInW * stride;
}

template <int kWarpsM>
__host__ __device__ constexpr int ring_bytes(int stride) {
  return kStages * kTapsPerStep * kTileN * stride >
                 kTapsPerStep * kWarpsM * 32 * 32 * 4
             ? kStages * kTapsPerStep * kTileN * stride
             : kTapsPerStep * kWarpsM * 32 * 32 * 4;
}

// Block: kWarpsM x kTapsPerStep warps.  Warp (wm, kw) computes output rows
// 2 wm, 2 wm + 1 of the block's tile (16 columns each), all kTileN channels
// of the block, over taps kw, kw + 4, kw + 8, ...; the four warps of an M
// slot then sum their int32 accumulators through shared memory (exact), and
// warp kw finishes N fragment kw (channels 8 kw .. 8 kw + 7).  `stride`: the
// pixel (and weight row) stride in shared memory, max c_pad + 16.
template <int kWarpsM>
__global__ void __launch_bounds__(32 * kWarpsM * kTapsPerStep)
conv7_s8_kernel(Groups groups, int G, const float* __restrict__ bias,
                int8_t* __restrict__ out, int H, int W, int O, int relu,
                int tiles_w, int stride) {
  constexpr int kThreads = 32 * kWarpsM * kTapsPerStep;
  constexpr int kTileH = 2 * kWarpsM;
  constexpr int kInH = kTileH + 6;
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* a_tile = smem;
  int8_t* ring = smem + tile_bytes<kWarpsM>(stride);
  int* partial = reinterpret_cast<int*>(ring);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_m = warp % kWarpsM;
  const int kw = warp / kWarpsM;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;

  // ldmatrix row addresses.  A: lane l reads output pixel column l % 16,
  // K bytes (l / 16) * 16 .. +15 (matrices: rows 0-7 | 8-15 x k 0-15 |
  // 16-31 = a0..a3).  B: lane l reads channel (l / 16) * 8 + l % 8, K bytes
  // ((l / 8) % 2) * 16 .. +15 (b0, b1 of two N fragments).
  const uint32_t a_lane =
      smem_addr(a_tile) +
      (uint32_t)((warp_m * 2 * kInW + lane % 16) * stride + (lane / 16) * 16);
  const uint32_t b_lane =
      smem_addr(ring) +
      (uint32_t)((kw * kTileN + (lane / 16) * 8 + lane % 8) * stride +
                 ((lane / 8) % 2) * 16);
  const uint32_t a_row_step = (uint32_t)(kInW * stride);
  const uint32_t b_half_step = (uint32_t)(16 * stride);
  const uint32_t slot_bytes = (uint32_t)(kTapsPerStep * kTileN * stride);

  float y[2][4];  // this warp's N fragment kw: [M fragment][element]
  for (int g = 0; g < G; ++g) {
    const int C = groups.c[g];
    const int CP = groups.c_pad[g];
    const int8_t* x = groups.x[g] + (size_t)b * H * W * C;
    const int8_t* w = groups.w[g];

    // The haloed input tile: pixel (ly, lx) is image pixel
    // (ty0 - 3 + ly, tx0 - 3 + lx), zero outside the image and past C.
    if (C % 16 == 0) {
      const int chunks = CP / 16;
      for (int i = threadIdx.x; i < kInH * kInW * chunks; i += kThreads) {
        const int p = i / chunks;
        const int k = i % chunks;
        const int gy = ty0 - 3 + p / kInW;
        const int gx = tx0 - 3 + p % kInW;
        const bool in =
            gy >= 0 && gy < H && gx >= 0 && gx < W && k * 16 < C;
        const int8_t* src = in ? x + ((size_t)gy * W + gx) * C + k * 16 : x;
        cp_async16(smem_addr(a_tile + p * stride + k * 16), src, in ? 16 : 0);
      }
    } else {
      const int words = CP / 4;
      for (int i = threadIdx.x; i < kInH * kInW * words; i += kThreads) {
        const int p = i / words;
        const int k = i % words;
        const int gy = ty0 - 3 + p / kInW;
        const int gx = tx0 - 3 + p % kInW;
        uint32_t word = 0;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const int8_t* px = x + ((size_t)gy * W + gx) * C;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = 4 * k + j;
            if (ch < C) word |= (uint32_t)(uint8_t)px[ch] << (8 * j);
          }
        }
        *reinterpret_cast<uint32_t*>(a_tile + p * stride + k * 4) = word;
      }
    }

    // Step `step`'s taps (4 step .. 4 step + 3, those below 49), this
    // block's channels, into ring slot `slot`: tap q of the step at row
    // q * kTileN.
    const int chunks = CP / 16;
    auto load_step = [&](int step, int slot) {
      const int taps = min(kTapsPerStep, kTaps - step * kTapsPerStep);
      int8_t* dst = ring + slot * slot_bytes;
      for (int i = threadIdx.x; i < taps * kTileN * chunks; i += kThreads) {
        const int row = i / chunks;  // q * kTileN + n
        const int k = i % chunks;
        const int tap = step * kTapsPerStep + row / kTileN;
        const int8_t* src =
            w + ((size_t)tap * O + n0 + row % kTileN) * CP + k * 16;
        cp_async16(smem_addr(dst + row * stride + k * 16), src, 16);
      }
    };
    // The first commit group also carries the input tile's copies.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      load_step(s, s);
      cp_async_commit();
    }

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int step = 0; step < kSteps; ++step) {
      cp_async_wait<kStages - 2>();  // step `step` (and the tile) landed
      __syncthreads();               // and every warp is done with step - 1
      if (step + kStages - 1 < kSteps)
        load_step(step + kStages - 1, (step + kStages - 1) % kStages);
      cp_async_commit();

      const int tap = step * kTapsPerStep + kw;
      if (tap >= kTaps) continue;
      const int dy = tap / 7;
      const int dx = tap % 7;
      const uint32_t a_tap = a_lane + (uint32_t)((dy * kInW + dx) * stride);
      const uint32_t b_tap = b_lane + (step % kStages) * slot_bytes;
      // Two fragment buffers: the next k32 step loads while this one's
      // MMAs run.
      Frags f0, f1;
      load_frags(f0, a_tap, a_row_step, b_tap, b_half_step);
      for (int kb = 0; kb < CP; kb += 64) {
        if (kb + 32 < CP)
          load_frags(f1, a_tap + kb + 32, a_row_step, b_tap + kb + 32,
                     b_half_step);
        mma_frags(acc, f0);
        if (kb + 32 >= CP) break;
        if (kb + 64 < CP)
          load_frags(f0, a_tap + kb + 64, a_row_step, b_tap + kb + 64,
                     b_half_step);
        mma_frags(acc, f1);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it takes the partial sums

    // partial[kw][warp_m][i][j][e][lane]: lanes contiguous.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          partial[((((kw * kWarpsM + warp_m) * 2 + i) * 4 + j) * 4 + e) * 32 +
                  lane] = acc[i][j][e];
    __syncthreads();

    // Warp kw sums N fragment j = kw over the four tap slices and folds it
    // into y: element e of fragment (i, kw) is pixel column
    // lane / 4 + 8 (e / 2), channel 8 kw + 2 (lane % 4) + e % 2.
    const int n = n0 + kw * 8 + 2 * (lane % 4);
    const float m0 = __ldg(groups.mult[g] + n);
    const float m1 = __ldg(groups.mult[g] + n + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int sum = 0;
#pragma unroll
        for (int q = 0; q < kTapsPerStep; ++q)
          sum += partial[((((q * kWarpsM + warp_m) * 2 + i) * 4 + kw) * 4 +
                          e) * 32 + lane];
        const float part = __fmul_rn(__int2float_rn(sum), e % 2 ? m1 : m0);
        y[i][e] = g == 0 ? part : __fadd_rn(y[i][e], part);
      }
    }
    __syncthreads();  // the next group restages the tile and the ring
  }

  const int n = n0 + kw * 8 + 2 * (lane % 4);
  const float b0 = __ldg(bias + n);
  const float b1 = __ldg(bias + n + 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = ty0 + warp_m * 2 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = tx0 + lane / 4 + 8 * h;
      if (gy >= H || gx >= W) continue;
      char2 v;
      v.x = finish(y[i][2 * h], b0, relu);
      v.y = finish(y[i][2 * h + 1], b1, relu);
      *reinterpret_cast<char2*>(out + (((size_t)b * H + gy) * W + gx) * O +
                                n) = v;
    }
  }
}

template <int kWarpsM>
int launch(const Groups& groups, int G, const float* bias, int8_t* out,
           int B, int H, int W, int O, int relu, int stride,
           cudaStream_t stream) {
  constexpr int kTileH = 2 * kWarpsM;
  // tpupose_torch/ops/conv7.py::smem_bytes computes the same budget.
  const int smem = tile_bytes<kWarpsM>(stride) + ring_bytes<kWarpsM>(stride);
  auto kernel = conv7_s8_kernel<kWarpsM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, O / kTileN, B);
  kernel<<<grid, 32 * kWarpsM * kTapsPerStep, smem, stream>>>(
      groups, G, bias, out, H, W, O, relu, tiles_w, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xs, ws, mults: G device pointers each (host arrays), to (B, H, W, c) int8,
// (49, O, c_pad) int8 and (O,) float32; channels, c_pads: G ints each;
// bias: (O,) float32; out: (B, H, W, O) int8.  `tile` indexes
// ops/conv7.py::TILE_ROWS: 4 or 8 output rows of 16 columns.  O must be a
// multiple of 32 and each c_pad a multiple of 32.
extern "C" int conv7_s8_launch(const void* const* xs, const void* const* ws,
                               const void* const* mults, const int* channels,
                               const int* c_pads, int G, const float* bias,
                               int8_t* out, int B, int H, int W, int O,
                               int relu, int tile, void* stream) {
  if (G < 1 || G > CONV7_MAX_GROUPS || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0 || O <= 0 || O % kTileN != 0)
    return (int)cudaErrorInvalidValue;
  Groups groups = {};
  int max_c_pad = 0;
  for (int g = 0; g < G; ++g) {
    if (channels[g] <= 0 || c_pads[g] % 32 != 0 || c_pads[g] < channels[g])
      return (int)cudaErrorInvalidValue;
    groups.x[g] = (const int8_t*)xs[g];
    groups.w[g] = (const int8_t*)ws[g];
    groups.mult[g] = (const float*)mults[g];
    groups.c[g] = channels[g];
    groups.c_pad[g] = c_pads[g];
    if (c_pads[g] > max_c_pad) max_c_pad = c_pads[g];
  }
  const int stride = max_c_pad + 16;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch<2>(groups, G, bias, out, B, H, W, O, relu, stride, s);
    case 1: return launch<4>(groups, G, bias, out, B, H, W, O, relu, stride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* conv7_s8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
