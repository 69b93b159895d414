// Fused separable Gaussian blur (SciPy reflect boundary) + strict 4-neighbour
// peak NMS for (N, H, W) float32 heatmaps, for Hopper (sm_90a).
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
// Bound: two floors of about the same size.  Each pixel moves 9 bytes (4 in,
// 4 + 1 out) and costs 2 * (2r + 1) multiplies, 2 * 2r adds and 5 compares
// that may not fuse, issued at the card's non-FMA float32 rate.  The design
// keeps the bytes at that floor and spends as few instructions as it can
// beyond the floating-point ones:
//   * one block per (map, 128-column strip, 32-row band).  Each thread owns
//     one column of the strip with its halo and streams the band's input rows
//     (with an r + 1 halo) straight from device memory, one coalesced load
//     per row issued kAhead rows ahead.  It keeps the running H-pass sums of
//     the 2r + 1 rows that row feeds in registers and adds the row into each
//     at its tap index; rows arrive in order, so every sum takes its taps in
//     order.  No input is staged in shared memory, and each is read once;
//   * a finished H-pass row goes to shared memory once.  The W pass loads a
//     run of 2r + 4 values with 16-byte loads and sums 4 outputs from
//     registers: about 1.5 shared loads per output instead of 2r + 1;
//   * the H pass runs in chunks of rows; after each chunk, its W pass and
//     the NMS of every band row whose three blurred rows are done, so the
//     block's stores spread over its life instead of coming all at the end.
//     The H buffer holds one chunk and a ring holds the blurred rows still
//     needed, so six blocks fit on an SM;
//   * mirroring costs one index per thread (its column) and one per band row
//     (a table built once per block); no loop divides or takes a remainder;
//   * the NMS reads the blurred rows from the ring and stores 16 bytes of
//     smoothed map and 4 bytes of mask per thread where W % 4 == 0.
// What is left holds it at about a third of its bound: instruction issue.
// The H pass computes 160 lanes of sums for 128 output columns (the halo and
// the warp's rounding) and 34 rows for 32, and each input row also costs its
// load, its address and reloads of the taps into uniform registers; with
// the W pass and the NMS a block issues about 1.6 times the floor's
// instructions, and its phases overlap only in part (PERF.md).
//
// Radii 17 to BLUR_NMS_MAX_TAPS_RADIUS (sigma >= 4.125) take a second kernel
// whose tap loops run at run time: the same blocks, each thread summing one
// H-pass value and then one W-pass value at a time from the taps in shared
// memory, in tap order, so it is bit-equal to the same plain version.  It
// is written to be right, not fast: it reads each input once per tap.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLUR_NMS_MAX_RADIUS 16
// The largest radius the run-time kernel takes: its taps travel by value in
// the launch's parameters (2 KiB of the 4 KiB they may hold).
#define BLUR_NMS_MAX_TAPS_RADIUS 255

namespace {

constexpr int kStripW = 128;  // output columns of a block
constexpr int kBandH = 32;    // output rows of a block
constexpr int kChunk = 20;    // H-pass rows per chunk
constexpr int kAhead = 8;     // input rows loaded ahead of the one summed
constexpr int kRuns = kStripW / 4;  // runs of 4 outputs per row: one warp
static_assert(kRuns == 32, "the W pass and the NMS give a row one warp");

struct Taps {
  float w[2 * BLUR_NMS_MAX_RADIUS + 1];
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ constexpr int min_int(int a, int b) {
  return a < b ? a : b;
}

template <int R>
struct Geometry {
  static constexpr int kTaps = 2 * R + 1;
  // H-pass rows: the band and one on each side (the NMS's neighbours).
  static constexpr int kRowsOut = kBandH + 2;
  static constexpr int kRowsIn = kRowsOut + 2 * R;
  // H-pass columns: the strip, one on each side, and the W pass's halo.
  static constexpr int kColsH = kStripW + 2 * R + 2;
  static constexpr int kThreads = round_up(kColsH, 32);
  static constexpr int kWarps = kThreads / 32;
  // Floats a W-pass run loads: 2r + 4, in whole 16-byte loads.
  static constexpr int kSpan = round_up(2 * R + 4, 4);
  // H buffer (one chunk): column s holds image column x0 - r - 4 + s, so a
  // run's loads start 16-byte aligned.  Blurred ring: a chunk and the two
  // rows before it; column s holds image column x0 - 4 + s.
  static constexpr int kHStride = kStripW + 4 + kSpan;
  static constexpr int kBStride = kStripW + 8;
  static constexpr int kBRows = 32;  // a power of 2 >= kChunk + 2
  static_assert(kBRows >= kChunk + 2 && (kBRows & (kBRows - 1)) == 0,
                "blurred ring");
  static constexpr int kTableInts = round_up(kRowsIn, 4);
  static constexpr int kSmemBytes =
      4 * (kTableInts + kChunk * kHStride + kBRows * kBStride);
  static_assert(kSmemBytes <= 48 * 1024, "static shared memory budget");
};

// numpy "symmetric" padding: period 2n, the edge sample mirrored with itself.
// Called once per thread and once per band row, never per element.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  int m = i % (2 * n);
  if (m < 0) m += 2 * n;
  return m < n ? m : 2 * n - 1 - m;
}

// What every stage of a block reads.
struct Block {
  const float* colp;    // this thread's column (mirrored) in the map's plane
  float* out_s;         // the map's smoothed plane
  uint8_t* out_m;       // the map's mask plane
  const int* row_off;   // input row i of the band: image row offset
  float* hbuf;
  float* bbuf;
  int H, W, x0, y0;
  bool live, store;     // its warp's columns are read; its column is used
};

// H pass over input rows [I0, I1): input row i is tap k of H-pass row i - k;
// row y = i - 2r is finished and goes to H buffer row y - Y0.
template <int R, int I0, int I1, int Y0>
__device__ __forceinline__ void h_rows(const Block& b, const Taps& taps,
                                       float (&v)[Geometry<R>::kRowsIn],
                                       float (&acc)[Geometry<R>::kRowsOut]) {
  using G = Geometry<R>;
  float* hcol = b.hbuf + threadIdx.x + 3;
  if (I0 == 0) {
#pragma unroll
    for (int a = 0; a < kAhead && a < G::kRowsIn; ++a)
      v[a] = __ldg(b.colp + b.row_off[a]);
  }
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    if (i + kAhead < G::kRowsIn)
      v[i + kAhead] = __ldg(b.colp + b.row_off[i + kAhead]);
#pragma unroll
    for (int k = 0; k < G::kTaps; ++k) {
      const int y = i - k;
      if (y < 0 || y >= G::kRowsOut) continue;
      const float p = __fmul_rn(v[i], taps.w[k]);
      acc[y] = k == 0 ? p : __fadd_rn(acc[y], p);
      if (k == 2 * R && b.store) hcol[(y - Y0) * G::kHStride] = acc[y];
    }
  }
}

// W pass of H-pass rows [y_begin, y_end): blurred row y (ring slot
// y & (kBRows - 1)) over the strip's runs of 4, one warp per row and one run
// per lane, then the two columns just outside the strip.  Runs and edges
// that no output of this block reads are skipped.
template <int R>
__device__ __forceinline__ void w_rows(const Block& b, const Taps& taps,
                                       int y_begin, int y_end) {
  using G = Geometry<R>;
  const int warp = threadIdx.x / 32, m = threadIdx.x % 32;
  const int y_first = b.x0 + 4 * m < b.W ? y_begin + warp : y_end;
  for (int y = y_first; y < y_end; y += G::kWarps) {
    const float* h = b.hbuf + (y - y_begin) * G::kHStride + 4 * m + 4;
    float in[G::kSpan];
#pragma unroll
    for (int q = 0; q < G::kSpan; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(h + q);
      in[q] = f.x;
      in[q + 1] = f.y;
      in[q + 2] = f.z;
      in[q + 3] = f.w;
    }
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = __fmul_rn(in[e], taps.w[0]);
#pragma unroll
      for (int k = 1; k < G::kTaps; ++k)
        o[e] = __fadd_rn(o[e], __fmul_rn(in[e + k], taps.w[k]));
    }
    *reinterpret_cast<float4*>(b.bbuf + (y & (G::kBRows - 1)) * G::kBStride +
                               4 * m + 4) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
  // Image columns x0 - 1 (task even) and x0 + kStripW (odd), for the NMS at
  // the strip's edges; from the last warp on.
  const int t = G::kThreads - 1 - threadIdx.x;
  if (t < 2 * (y_end - y_begin)) {
    const int y = y_begin + t / 2;
    const bool left = t % 2 == 0;
    if (left ? b.x0 > 0 : b.x0 + kStripW < b.W) {
      const int s = left ? 3 : kStripW + 4;
      const float* h = b.hbuf + (y - y_begin) * G::kHStride + s;
      float o = __fmul_rn(h[0], taps.w[0]);
#pragma unroll
      for (int k = 1; k < G::kTaps; ++k)
        o = __fadd_rn(o, __fmul_rn(h[k], taps.w[k]));
      b.bbuf[(y & (G::kBRows - 1)) * G::kBStride + s] = o;
    }
  }
}

// NMS of band rows [ty_begin, ty_end) (image rows y0 + ty; blurred rows
// ty .. ty + 2 are in the ring), one warp per row, 4 pixels per lane: 16
// bytes of smoothed map and 4 of mask per store where W % 4 == 0.
template <int R>
__device__ __forceinline__ void nms_rows(const Block& b, float thresh,
                                         int ty_begin, int ty_end) {
  using G = Geometry<R>;
  const int warp = threadIdx.x / 32, m = threadIdx.x % 32;
  const int gx = b.x0 + 4 * m;
  if (gx >= b.W) return;
  const bool vec = (b.W & 3) == 0;
  for (int ty = ty_begin + warp; ty < ty_end; ty += G::kWarps) {
    const int gy = b.y0 + ty;
    if (gy >= b.H) break;
    const float* ring = b.bbuf + 4 * m + 4;
    const float* up = ring + (ty & (G::kBRows - 1)) * G::kBStride;
    const float* mid = ring + ((ty + 1) & (G::kBRows - 1)) * G::kBStride;
    const float* dn = ring + ((ty + 2) & (G::kBRows - 1)) * G::kBStride;
    const float4 c = *reinterpret_cast<const float4*>(mid);
    const float4 u = *reinterpret_cast<const float4*>(up);
    const float4 d = *reinterpret_cast<const float4*>(dn);
    const float row[6] = {mid[-1], c.x, c.y, c.z, c.w, mid[4]};
    const float ups[4] = {u.x, u.y, u.z, u.w};
    const float downs[4] = {d.x, d.y, d.z, d.w};
    const bool has_up = gy > 0, has_down = gy < b.H - 1;
    uint32_t bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float val = row[e + 1];
      const float l = gx + e > 0 ? row[e] : 0.0f;
      const float r = gx + e < b.W - 1 ? row[e + 2] : 0.0f;
      const float n = has_up ? ups[e] : 0.0f;
      const float s = has_down ? downs[e] : 0.0f;
      const bool peak = (val > thresh) && (val > n) && (val > s) &&
                        (val > l) && (val > r);
      bits |= (uint32_t)peak << (8 * e);
    }
    const size_t o = (size_t)gy * b.W + gx;
    if (vec) {
      *reinterpret_cast<float4*>(b.out_s + o) = c;
      *reinterpret_cast<uint32_t*>(b.out_m + o) = bits;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gx + e < b.W) {
          b.out_s[o + e] = row[e + 1];
          b.out_m[o + e] = (uint8_t)((bits >> (8 * e)) & 1u);
        }
      }
    }
  }
}

// Chunk C: the H pass of the input rows that finish H-pass rows
// [C * kChunk, ...), their W pass, then the NMS of every band row whose
// three blurred rows are done; then the next chunk.
template <int R, int C>
__device__ __forceinline__ void chunk(const Block& b, const Taps& taps,
                                      float thresh,
                                      float (&v)[Geometry<R>::kRowsIn],
                                      float (&acc)[Geometry<R>::kRowsOut]) {
  using G = Geometry<R>;
  constexpr int y_begin = C * kChunk;
  constexpr int y_end = min_int(y_begin + kChunk, G::kRowsOut);
  if (b.live)
    h_rows<R, C == 0 ? 0 : y_begin + 2 * R, y_end + 2 * R, y_begin>(
        b, taps, v, acc);
  __syncthreads();
  w_rows<R>(b, taps, y_begin, y_end);
  __syncthreads();
  nms_rows<R>(b, thresh, y_begin < 2 ? 0 : y_begin - 2,
              min_int(y_end - 2, kBandH));
  if constexpr (y_end < G::kRowsOut)
    chunk<R, C + 1>(b, taps, thresh, v, acc);
}

template <int R>
__global__ void __launch_bounds__(Geometry<R>::kThreads)
blur_nms_kernel(const float* __restrict__ x, float* __restrict__ smoothed,
                uint8_t* __restrict__ mask, int H, int W, Taps taps,
                float thresh) {
  using G = Geometry<R>;
  __shared__ __align__(16) int smem[G::kSmemBytes / 4];
  const int t = threadIdx.x;
  const size_t plane = (size_t)H * W;
  Block b;
  b.out_s = smoothed + blockIdx.z * plane;
  b.out_m = mask + blockIdx.z * plane;
  b.row_off = smem;
  b.hbuf = reinterpret_cast<float*>(smem + G::kTableInts);
  b.bbuf = b.hbuf + kChunk * G::kHStride;
  b.H = H;
  b.W = W;
  b.x0 = blockIdx.x * kStripW;
  b.y0 = blockIdx.y * kBandH;
  // Thread t sums image column x0 - r - 1 + t (H buffer column t + 3).  A
  // warp whose columns no output of this block reads (the ragged last
  // strip) skips the H pass but keeps every barrier.
  b.colp = x + blockIdx.z * plane + reflect_index(b.x0 - R - 1 + t, W);
  // Opaque to the compiler, so each row's address is one multiply-add on
  // this pointer instead of a 64-bit sum rebuilt from its parts.
  asm("" : "+l"(b.colp));
  b.live = 32 * (t / 32) <= W - b.x0 + 2 * R;
  b.store = t < G::kColsH;

  // Input row i is image row y0 - r - 1 + i; H-pass row y is y0 - 1 + y.
  for (int i = t; i < G::kRowsIn; i += G::kThreads)
    smem[i] = reflect_index(b.y0 - R - 1 + i, H) * W;
  __syncthreads();

  // Every index into v and acc is a constant once the passes are unrolled,
  // so both live in registers: at most kAhead + 1 values of v and 2r + 1
  // sums of acc at a time.
  float v[G::kRowsIn];
  float acc[G::kRowsOut];
  chunk<R, 0>(b, taps, thresh, v, acc);
}

template <int R>
int launch(const float* x, float* smoothed, uint8_t* mask, int J, int H,
           int W, const Taps& taps, float thresh, cudaStream_t stream) {
  using G = Geometry<R>;
  const dim3 grid((W + kStripW - 1) / kStripW, (H + kBandH - 1) / kBandH, J);
  blur_nms_kernel<R><<<grid, G::kThreads, 0, stream>>>(x, smoothed, mask, H,
                                                      W, taps, thresh);
  return (int)cudaGetLastError();
}

// One instantiation per radius: the unrolled passes need it at compile time.
template <int R>
int launch_radius(int radius, const float* x, float* smoothed, uint8_t* mask,
                  int J, int H, int W, const Taps& taps, float thresh,
                  cudaStream_t stream) {
  if (radius == R)
    return launch<R>(x, smoothed, mask, J, H, W, taps, thresh, stream);
  if constexpr (R < BLUR_NMS_MAX_RADIUS)
    return launch_radius<R + 1>(radius, x, smoothed, mask, J, H, W, taps,
                                thresh, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Radii above BLUR_NMS_MAX_RADIUS: tap loops at run time.
// ---------------------------------------------------------------------------

struct TapsAny {
  float w[2 * BLUR_NMS_MAX_TAPS_RADIUS + 1];
};

constexpr int kAnyThreads = 256;
constexpr int kAnyRowsOut = kBandH + 2;   // the band and its two neighbours
constexpr int kAnyColsB = kStripW + 2;    // the strip and its two neighbours

// Shared memory, in 4-byte words: the taps, the mirrored input row table,
// the H buffer (kAnyRowsOut rows of the strip, its neighbours and the W
// pass's halo) and the blurred rows.
__host__ __device__ constexpr int any_smem_words(int r) {
  return (2 * r + 1) + (kAnyRowsOut + 2 * r) +
         kAnyRowsOut * (kStripW + 2 * r + 2) + kAnyRowsOut * kAnyColsB;
}

__global__ void __launch_bounds__(kAnyThreads)
blur_nms_any_kernel(const float* __restrict__ x, float* __restrict__ smoothed,
                    uint8_t* __restrict__ mask, int H, int W, TapsAny taps,
                    int R, float thresh) {
  extern __shared__ __align__(16) int smem_any[];
  const int n_taps = 2 * R + 1;
  const int rows_in = kAnyRowsOut + 2 * R;
  const int cols_h = kStripW + 2 * R + 2;
  float* w = reinterpret_cast<float*>(smem_any);
  int* row_off = smem_any + n_taps;
  float* hbuf = reinterpret_cast<float*>(row_off + rows_in);
  float* bbuf = hbuf + kAnyRowsOut * cols_h;
  const int t = threadIdx.x;
  const size_t plane = (size_t)H * W;
  const float* xp = x + blockIdx.z * plane;
  const int x0 = blockIdx.x * kStripW, y0 = blockIdx.y * kBandH;
  for (int k = t; k < n_taps; k += kAnyThreads) w[k] = taps.w[k];
  // Input row i is image row y0 - R - 1 + i.
  for (int i = t; i < rows_in; i += kAnyThreads)
    row_off[i] = reflect_index(y0 - R - 1 + i, H) * W;
  __syncthreads();
  // H pass: row y is image row y0 - 1 + y, column c image column
  // x0 - R - 1 + c; it sums input rows y .. y + 2R.
  for (int e = t; e < kAnyRowsOut * cols_h; e += kAnyThreads) {
    const int y = e / cols_h, c = e - y * cols_h;
    const float* col = xp + reflect_index(x0 - R - 1 + c, W);
    float acc = __fmul_rn(__ldg(col + row_off[y]), w[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(col + row_off[y + k]), w[k]));
    hbuf[e] = acc;
  }
  __syncthreads();
  // W pass: blurred column j (image column x0 - 1 + j) sums H-buffer
  // columns j .. j + 2R.
  for (int e = t; e < kAnyRowsOut * kAnyColsB; e += kAnyThreads) {
    const int y = e / kAnyColsB, j = e - y * kAnyColsB;
    const float* h = hbuf + y * cols_h + j;
    float acc = __fmul_rn(h[0], w[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(h[k], w[k]));
    bbuf[e] = acc;
  }
  __syncthreads();
  // NMS of the band: neighbours outside the image count as 0.
  for (int e = t; e < kBandH * kStripW; e += kAnyThreads) {
    const int ty = e / kStripW, tx = e - ty * kStripW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    const float* b = bbuf + (ty + 1) * kAnyColsB + tx + 1;
    const float v = b[0];
    const float l = gx > 0 ? b[-1] : 0.0f;
    const float r = gx < W - 1 ? b[1] : 0.0f;
    const float n = gy > 0 ? b[-kAnyColsB] : 0.0f;
    const float s = gy < H - 1 ? b[kAnyColsB] : 0.0f;
    const size_t o = blockIdx.z * plane + (size_t)gy * W + gx;
    smoothed[o] = v;
    mask[o] = (uint8_t)((v > thresh) && (v > n) && (v > s) && (v > l) &&
                        (v > r));
  }
}

int launch_any(int radius, const float* x, float* smoothed, uint8_t* mask,
               int J, int H, int W, const float* taps, float thresh,
               cudaStream_t stream) {
  TapsAny t = {};
  for (int k = 0; k < 2 * radius + 1; ++k) t.w[k] = taps[k];
  // Radii above 47 need more than the 48 KiB a block gets without asking
  // (108,940 bytes at radius 255).
  const int smem = 4 * any_smem_words(radius);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_nms_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + kStripW - 1) / kStripW, (H + kBandH - 1) / kBandH, J);
  blur_nms_any_kernel<<<grid, kAnyThreads, smem, stream>>>(
      x, smoothed, mask, H, W, t, radius, thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, smoothed: (J, H, W) float32 contiguous; mask: (J, H, W) one byte each,
// both outputs 16-byte aligned; taps: 2 * radius + 1 host floats.  Radii
// 0-16 take the unrolled kernel, 17 to BLUR_NMS_MAX_TAPS_RADIUS the run-time
// one.
extern "C" int blur_nms_launch(const float* x, float* smoothed, uint8_t* mask,
                               int J, int H, int W, const float* taps,
                               int radius, float thresh, void* stream) {
  if (J <= 0 || H <= 0 || W <= 0 || J > 65535 || H > 65535 * kBandH ||
      radius < 0 || radius > BLUR_NMS_MAX_TAPS_RADIUS)
    return (int)cudaErrorInvalidValue;
  if (radius > BLUR_NMS_MAX_RADIUS)
    return launch_any(radius, x, smoothed, mask, J, H, W, taps, thresh,
                      (cudaStream_t)stream);
  Taps t = {};
  for (int k = 0; k < 2 * radius + 1; ++k) t.w[k] = taps[k];
  return launch_radius<0>(radius, x, smoothed, mask, J, H, W, t, thresh,
                          (cudaStream_t)stream);
}

extern "C" const char* blur_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
