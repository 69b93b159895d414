// cv2's fixed-point uint8 INTER_LINEAR resize of a batch of HWC (3-channel)
// images of different sizes, each optionally mirrored, to one output size,
// for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package resizes each crop on the host
// with cv2.resize (tpupose/detectors/crop_keypoints.py:214).  The port's
// crop path uploads the raw crops packed back to back and resizes all of a
// request's crops here, in one launch.  Semantics are those of
// tpupose_torch/ops/resize.py::resize_u8_linear (and of its plain PyTorch
// twin in the same module), bit for bit:
//   * taps per output column and row as _cv2_linear_taps computes them:
//     f = float32((x + 0.5) * scale - 0.5) in float64, scale = 1 / (out /
//     in); src = floor(f); the float32 fraction; 11-bit coefficients
//     rint((1 - frac) * 2048) and rint(frac * 2048), rounding half to even.
//     Columns clamp the source at both borders (fraction 0 there); rows
//     keep the raw index and clamp the two rows they read.  Every float64
//     and float32 operation is an explicit _rn intrinsic: NVCC_FLAGS leave
//     -fmad on, and a contracted FMA would move a tap;
//   * an exact integer horizontal pass, (p0 * a0 + p1 * a1) >> 4, and the
//     vertical pass with cv2's SIMD descale, ((S0 * b0) >> 16) +
//     ((S1 * b1) >> 16) + 2 >> 2, saturated to 0..255;
//   * a mirrored item reads source column in_w - 1 - x, which is c[:, ::-1]
//     followed by the resize.  Equal input and output sizes give the input
//     back (the taps are then the identity).
//
// Bound: bytes.  A request of 8 crops of 64-192 px to 368 x 368 reads about
// 0.43 MB and writes 3.25 MB, about 1.1 us at 3.35 TB/s, so the design goal
// is one launch a request: the items travel by value in the launch's
// parameters (RESIZE_U8_MAX_ITEMS a launch, no table copy).  One block per
// (band of kRows output rows, item); its threads first compute the band's
// row taps and the item's column taps (byte offsets with the mirror folded
// in, and coefficients, one 16-byte entry a column) into shared memory.
// Then each thread computes kPixels consecutive output pixels of a row:
// one shared load of a pixel's taps serves its three channels, and the
// 48 bytes go out as three 16-byte stores where the row is 16-byte aligned
// (368 x 3 = 1,104 B = 23 x 48 B).  Source bytes are read one at a time
// through the read-only cache, where a band's rows stay.  What is left
// holds it above its bound: four byte loads an output byte and the
// per-block tap set-up, on 2-3 blocks an SM at the hand request
// (PERF.md: 0.0112 ms there, 0.0177 ms when a thread took 16 bytes and
// re-read a pixel's taps for each channel).

#include <cuda_runtime.h>
#include <stdint.h>

// Must equal MAX_ITEMS in tpupose_torch/ops/resize.py.
#define RESIZE_U8_MAX_ITEMS 64
// The widest output row whose column taps fit the 48 KiB of shared memory
// a block gets without opting in (16 B a column).
#define RESIZE_U8_MAX_OUT_W 2048

namespace {

constexpr int kC = 3;          // channels
constexpr int kRows = 8;       // output rows a block
constexpr int kThreads = 256;
constexpr int kPixels = 16;   // output pixels a thread writes (48 B)

struct Item {
  long long offset;  // byte offset of the item's (in_h, in_w, 3) image
  int in_h, in_w, mirror, pad;
};

struct Batch {
  Item item[RESIZE_U8_MAX_ITEMS];
};

// cv2's source index and float32 fraction of output index i, for an axis of
// `in` source and `out` output samples.
__device__ __forceinline__ void source_of(int i, int in, int out, int& src,
                                          float& frac) {
  const double scale = __ddiv_rn(1.0, __ddiv_rn((double)out, (double)in));
  const float f = __double2float_rn(
      __dadd_rn(__dmul_rn(__dadd_rn((double)i, 0.5), scale), -0.5));
  const float fl = floorf(f);
  src = (int)fl;
  frac = __fsub_rn(f, fl);
}

__device__ __forceinline__ int coef(float w) {
  return (int)rintf(__fmul_rn(w, 2048.0f));
}

__global__ void __launch_bounds__(kThreads)
resize_u8_linear_kernel(const uint8_t* __restrict__ src,
                        uint8_t* __restrict__ dst, const Batch batch,
                        int out_h, int out_w) {
  extern __shared__ __align__(16) int smem[];
  int4* s_x = reinterpret_cast<int4*>(smem);   // out_w: x0, x1, a0, a1
  int* s_y0 = smem + 4 * out_w;   // kRows: byte offset of the upper row
  int* s_y1 = s_y0 + kRows;       // kRows: of the lower row
  int* s_b0 = s_y1 + kRows;       // kRows: coefficients
  int* s_b1 = s_b0 + kRows;

  const Item it = batch.item[blockIdx.y];
  const int in_h = it.in_h, in_w = it.in_w;
  const int y0 = blockIdx.x * kRows;
  const int rows = min(kRows, out_h - y0);

  for (int x = threadIdx.x; x < out_w; x += kThreads) {
    int sx;
    float f;
    source_of(x, in_w, out_w, sx, f);
    if (sx < 0 || sx >= in_w - 1) {
      f = 0.0f;
      sx = min(max(sx, 0), in_w - 1);
    }
    int sx1 = min(sx + 1, in_w - 1);
    if (it.mirror) {
      sx = in_w - 1 - sx;
      sx1 = in_w - 1 - sx1;
    }
    s_x[x] = make_int4(sx * kC, sx1 * kC, coef(__fsub_rn(1.0f, f)), coef(f));
  }
  if (threadIdx.x < rows) {
    int sy;
    float f;
    source_of(y0 + threadIdx.x, in_h, out_h, sy, f);
    s_y0[threadIdx.x] = min(max(sy, 0), in_h - 1) * in_w * kC;
    s_y1[threadIdx.x] = min(max(sy + 1, 0), in_h - 1) * in_w * kC;
    s_b0[threadIdx.x] = coef(__fsub_rn(1.0f, f));
    s_b1[threadIdx.x] = coef(f);
  }
  __syncthreads();

  const int row_bytes = out_w * kC;
  const int groups = (out_w + kPixels - 1) / kPixels;
  const uint8_t* img = src + it.offset;
  uint8_t* out = dst + ((long long)blockIdx.y * out_h + y0) * row_bytes;
  for (int t = threadIdx.x; t < rows * groups; t += kThreads) {
    const int r = t / groups;
    const int x0 = (t - r * groups) * kPixels;
    const int n = min(kPixels, out_w - x0);
    const uint8_t* p0 = img + s_y0[r];
    const uint8_t* p1 = img + s_y1[r];
    const int b0 = s_b0[r], b1 = s_b1[r];
    uint32_t word[kPixels * kC / 4];
#pragma unroll
    for (int i = 0; i < kPixels * kC / 4; ++i) word[i] = 0u;
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      if (i < n) {
        const int4 tap = s_x[x0 + i];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int h0 = ((int)__ldg(p0 + tap.x + c) * tap.z +
                          (int)__ldg(p0 + tap.y + c) * tap.w) >> 4;
          const int h1 = ((int)__ldg(p1 + tap.x + c) * tap.z +
                          (int)__ldg(p1 + tap.y + c) * tap.w) >> 4;
          const int v = (((h0 * b0) >> 16) + ((h1 * b1) >> 16) + 2) >> 2;
          const int j = i * kC + c;
          word[j >> 2] |= (uint32_t)min(max(v, 0), 255) << (8 * (j & 3));
        }
      }
    }
    uint8_t* d = out + (long long)r * row_bytes + x0 * kC;
    if (n == kPixels && ((uintptr_t)d & 15) == 0) {
#pragma unroll
      for (int q = 0; q < kPixels * kC / 16; ++q)
        reinterpret_cast<uint4*>(d)[q] = make_uint4(
            word[4 * q], word[4 * q + 1], word[4 * q + 2], word[4 * q + 3]);
    } else {
      for (int j = 0; j < n * kC; ++j)
        d[j] = (uint8_t)(word[j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace

// src: the packed images; dst: (n, out_h, out_w, 3) uint8; items: n rows of
// (byte offset, in_h, in_w, mirror) as int64.
extern "C" int resize_u8_launch(const uint8_t* src, uint8_t* dst,
                                const long long* items, int n, int out_h,
                                int out_w, void* stream) {
  if (n <= 0 || n > RESIZE_U8_MAX_ITEMS || out_h <= 0 || out_w <= 0 ||
      out_w > RESIZE_U8_MAX_OUT_W)
    return (int)cudaErrorInvalidValue;
  Batch batch;
  for (int i = 0; i < n; ++i) {
    const long long* row = items + 4 * i;
    if (row[0] < 0 || row[1] <= 0 || row[2] <= 0 ||
        row[1] * row[2] * kC > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    batch.item[i] = Item{row[0], (int)row[1], (int)row[2], row[3] ? 1 : 0, 0};
  }
  const int smem = (4 * out_w + 4 * kRows) * (int)sizeof(int);
  const dim3 grid((out_h + kRows - 1) / kRows, n);
  resize_u8_linear_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      src, dst, batch, out_h, out_w);
  return (int)cudaGetLastError();
}

extern "C" const char* resize_u8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
