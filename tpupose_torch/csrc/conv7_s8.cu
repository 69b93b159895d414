// int8 x int8 -> int32 7x7 SAME convolution over G input groups with the
// w8a8 epilogue fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpupose/ops/pallas/conv7.py::conv7_s8 (with
// its body _make_kernel).  Semantics are those of tpupose_torch/ops/conv7.py::
// conv7_s8_reference, bit for bit:
//   acc_g = sum over the 7x7 window and the C_g channels of x_g * w_g (int32,
//           exact; zero padding outside the image)
//   y     = acc_0 * mult_0 (+ acc_1 * mult_1 ...) + bias, in float32, each
//           product and sum rounded on its own in that order
//           (__fmul_rn/__fadd_rn: nvcc would otherwise contract to FMAs)
//   out   = clip(rint(max(y, 0)), 0, 127) as int8 (max only with `relu`).
//
// Layout: activations NHWC int8; weights packed once by the wrapper into
// int32 words (49 taps, C4 words, O): word k of tap t for output o holds
// input channels 4k..4k+3, the channels zero-padded to a multiple of 16, so
// every __dp4a sums four exact int8 products.
//
// Bound: integer operations on the CUDA cores.  A 7x7 128 -> 128 layer at a
// 46x62 grid is 2.3 GMAC, 0.57 G __dp4a; device memory traffic is small
// (activations ~0.4 MB, weights 0.8 MB per group, served from L2).  The
// design keeps every operand out of device memory after one read: one block
// per (image, 4x8 output tile, 64 output channels) stages the haloed 10x14
// input tile of a group in shared memory, each thread holds 16 pixel
// accumulators of one output channel, and each 16-byte shared load feeds
// four __dp4a against four weight words held in registers.  Groups run one
// after another through the same shared tile.  The tensor cores (mma.sync
// or wgmma s8) would be the next step; this first kernel keeps to __dp4a.

#include <cuda_runtime.h>
#include <stdint.h>

#define CONV7_MAX_GROUPS 4

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 8;
constexpr int kInH = kTileH + 6;
constexpr int kInW = kTileW + 6;
constexpr int kOutBlock = 64;  // output channels per block
constexpr int kRowsPerThread = 2;
constexpr int kThreads = kOutBlock * (kTileH / kRowsPerThread);  // 128
constexpr int kPix = kRowsPerThread * kTileW;                    // 16

struct Groups {
  const int8_t* x[CONV7_MAX_GROUPS];   // (B, H, W, c) int8
  const int32_t* w[CONV7_MAX_GROUPS];  // (49, c4, O) packed int32 words
  int c[CONV7_MAX_GROUPS];             // channels
  int c4[CONV7_MAX_GROUPS];            // words per pixel, a multiple of 4
};

__global__ void __launch_bounds__(kThreads)
conv7_s8_kernel(Groups groups, int G, const float* __restrict__ mult,
                const float* __restrict__ bias, int8_t* __restrict__ out,
                int H, int W, int O, int relu, int tiles_w) {
  extern __shared__ int4 smem[];
  int32_t* tile = reinterpret_cast<int32_t*>(smem);

  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int o = blockIdx.y * kOutBlock + threadIdx.x % kOutBlock;
  const int r0 = (threadIdx.x / kOutBlock) * kRowsPerThread;
  const int b = blockIdx.z;

  float y[kPix];
  for (int g = 0; g < G; ++g) {
    const int C = groups.c[g];
    const int C4 = groups.c4[g];
    const int8_t* x = groups.x[g] + (size_t)b * H * W * C;

    // Haloed input tile: word (ly, lx, k) holds channels 4k..4k+3 of pixel
    // (ty0 - 3 + ly, tx0 - 3 + lx), zero outside the image and past C.
    const int n_words = kInH * kInW * C4;
    for (int i = threadIdx.x; i < n_words; i += kThreads) {
      const int k = i % C4;
      const int p = i / C4;
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
      tile[i] = (int32_t)word;
    }
    __syncthreads();

    int acc[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) acc[p] = 0;
    const int32_t* wg = groups.w[g] + o;
    for (int dy = 0; dy < 7; ++dy) {
      for (int dx = 0; dx < 7; ++dx) {
        const int32_t* wt = wg + (size_t)(dy * 7 + dx) * C4 * O;
        for (int k = 0; k < C4; k += 4) {
          const int w0 = __ldg(wt + (size_t)(k + 0) * O);
          const int w1 = __ldg(wt + (size_t)(k + 1) * O);
          const int w2 = __ldg(wt + (size_t)(k + 2) * O);
          const int w3 = __ldg(wt + (size_t)(k + 3) * O);
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
            for (int cx = 0; cx < kTileW; ++cx) {
              const int4 v = *reinterpret_cast<const int4*>(
                  tile + ((r0 + r + dy) * kInW + cx + dx) * C4 + k);
              int a = acc[r * kTileW + cx];
              a = __dp4a(v.x, w0, a);
              a = __dp4a(v.y, w1, a);
              a = __dp4a(v.z, w2, a);
              a = __dp4a(v.w, w3, a);
              acc[r * kTileW + cx] = a;
            }
          }
        }
      }
    }

    const float m = mult[g * O + o];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float part = __fmul_rn(__int2float_rn(acc[p]), m);
      y[p] = g == 0 ? part : __fadd_rn(y[p], part);
    }
    __syncthreads();  // the next group overwrites the tile
  }

  const float bo = bias[o];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int cx = 0; cx < kTileW; ++cx) {
      const int gy = ty0 + r0 + r;
      const int gx = tx0 + cx;
      if (gy >= H || gx >= W) continue;
      float v = __fadd_rn(y[r * kTileW + cx], bo);
      if (relu) v = fmaxf(v, 0.0f);
      v = fminf(fmaxf(rintf(v), 0.0f), 127.0f);
      out[(((size_t)b * H + gy) * W + gx) * O + o] = (int8_t)(int)v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xs, ws: G device pointers (host arrays); channels, c4s: G ints each;
// mult: (G, O) float32; bias: (O,) float32; out: (B, H, W, O) int8.
// O must be a multiple of 64 and each c4 a multiple of 4.
extern "C" int conv7_s8_launch(const void* const* xs, const void* const* ws,
                               const int* channels, const int* c4s, int G,
                               const float* mult, const float* bias,
                               int8_t* out, int B, int H, int W, int O,
                               int relu, void* stream) {
  if (G < 1 || G > CONV7_MAX_GROUPS || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0 || O <= 0 || O % kOutBlock != 0)
    return (int)cudaErrorInvalidValue;
  Groups groups = {};
  int max_c4 = 0;
  for (int g = 0; g < G; ++g) {
    if (channels[g] <= 0 || c4s[g] % 4 != 0 || 4 * c4s[g] < channels[g])
      return (int)cudaErrorInvalidValue;
    groups.x[g] = (const int8_t*)xs[g];
    groups.w[g] = (const int32_t*)ws[g];
    groups.c[g] = channels[g];
    groups.c4[g] = c4s[g];
    if (c4s[g] > max_c4) max_c4 = c4s[g];
  }
  // tpupose_torch/ops/conv7.py::smem_bytes computes the same budget.
  const int smem = kInH * kInW * max_c4 * (int)sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv7_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, O / kOutBlock, B);
  conv7_s8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      groups, G, mult, bias, out, H, W, O, relu, tiles_w);
  return (int)cudaGetLastError();
}

extern "C" const char* conv7_s8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
