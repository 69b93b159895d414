// Fused separable Gaussian blur (SciPy reflect boundary) + strict 4-neighbour
// peak NMS for (J, H, W) float32 heatmaps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpupose/ops/pallas/blur_nms.py::
// blur_nms_pallas (with its body _make_kernel).  Semantics are those of
// tpupose_torch/ops/blur_nms.py::blur_nms_reference:
//   * rows first, then columns; each pass accumulates x0*w0, then
//     acc + xk*wk in tap order, every product and sum rounded to float32 on
//     its own.  __fmul_rn/__fadd_rn keep nvcc from contracting them to FMAs,
//     so the smoothed map equals PyTorch's eager version bit for bit;
//   * out-of-image samples mirror numpy's "symmetric" pad, repeating for
//     maps smaller than the radius;
//   * mask = v > thresh and v > each of the 4 neighbours, where a neighbour
//     outside the image counts as 0.
//
// Bound: device-memory bandwidth.  Each output costs 21 + 21 multiply-adds
// (radius 10) per 4 B read and 5 B written, far below the card's ratio of
// operations to bytes.  The design keeps traffic at one read and one write
// per pixel: one block per (channel, 32x64 output tile) loads the tile with a
// halo of r + 1 into shared memory, mirroring indices in the kernel so no
// padded copy goes to device memory, and runs both blur passes and the NMS
// there.  The halo costs about 2.3x the tile's reads at r = 10; neighbouring
// blocks share it through L2.  The extra blurred row and column on each side
// are what the NMS compares the tile's edge pixels against.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLUR_NMS_MAX_RADIUS 16

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;

struct Taps {
  float w[2 * BLUR_NMS_MAX_RADIUS + 1];
};

// numpy "symmetric" padding: period 2n, the edge sample mirrored with itself.
__device__ __forceinline__ int reflect_index(int i, int n) {
  int m = i % (2 * n);
  if (m < 0) m += 2 * n;
  return m < n ? m : 2 * n - 1 - m;
}

__global__ void __launch_bounds__(kThreads)
blur_nms_kernel(const float* __restrict__ x, float* __restrict__ smoothed,
                uint8_t* __restrict__ mask, int H, int W, Taps taps, int r,
                float thresh) {
  extern __shared__ float smem[];
  const int in_h = kTileH + 2 * r + 2;
  const int in_w = kTileW + 2 * r + 2;
  const int ext_h = kTileH + 2;
  const int ext_w = kTileW + 2;
  const int n_taps = 2 * r + 1;
  // `tile` holds the haloed input, later the blurred (ext_h, ext_w) tile;
  // `rows` holds the row pass, (ext_h, in_w).
  float* tile = smem;
  float* rows = smem + in_h * in_w;

  const int c = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)H * W;
  const float* src = x + c * plane;

  for (int i = threadIdx.x; i < in_h * in_w; i += kThreads) {
    const int ly = i / in_w, lx = i - ly * in_w;
    const int gy = reflect_index(y0 - r - 1 + ly, H);
    const int gx = reflect_index(x0 - r - 1 + lx, W);
    tile[i] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Row pass: rows[ry][rx] is the blur over H of global row y0 - 1 + ry.
  for (int i = threadIdx.x; i < ext_h * in_w; i += kThreads) {
    const int ry = i / in_w, rx = i - ry * in_w;
    const float* p = tile + ry * in_w + rx;
    float acc = __fmul_rn(p[0], taps.w[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(p[k * in_w], taps.w[k]));
    rows[i] = acc;
  }
  __syncthreads();

  // Column pass: tile[sy][sx] is global pixel (y0 - 1 + sy, x0 - 1 + sx).
  for (int i = threadIdx.x; i < ext_h * ext_w; i += kThreads) {
    const int sy = i / ext_w, sx = i - sy * ext_w;
    const float* p = rows + sy * in_w + sx;
    float acc = __fmul_rn(p[0], taps.w[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(p[k], taps.w[k]));
    tile[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i - ty * kTileW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    const float* s = tile + (ty + 1) * ext_w + (tx + 1);
    const float v = s[0];
    const float up = gy > 0 ? s[-ext_w] : 0.0f;
    const float down = gy < H - 1 ? s[ext_w] : 0.0f;
    const float left = gx > 0 ? s[-1] : 0.0f;
    const float right = gx < W - 1 ? s[1] : 0.0f;
    const size_t o = c * plane + (size_t)gy * W + gx;
    smoothed[o] = v;
    mask[o] = (v > thresh) && (v > up) && (v > down) && (v > left) &&
              (v > right);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, smoothed: (J, H, W) float32 contiguous; mask: (J, H, W) one byte each;
// taps: 2 * radius + 1 host floats.
extern "C" int blur_nms_launch(const float* x, float* smoothed, uint8_t* mask,
                               int J, int H, int W, const float* taps,
                               int radius, float thresh, void* stream) {
  if (J <= 0 || H <= 0 || W <= 0 || J > 65535 || radius < 0 ||
      radius > BLUR_NMS_MAX_RADIUS)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int k = 0; k < 2 * radius + 1; ++k) t.w[k] = taps[k];
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, J);
  const int in_w = kTileW + 2 * radius + 2;
  const size_t smem =
      sizeof(float) * ((size_t)(kTileH + 2 * radius + 2) * in_w +
                       (size_t)(kTileH + 2) * in_w);
  blur_nms_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, smoothed, mask, H, W, t, radius, thresh);
  return (int)cudaGetLastError();
}

extern "C" const char* blur_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
