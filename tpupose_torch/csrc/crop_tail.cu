// Every crop's keypoint tail of a face or hand request in one launch, for
// Hopper (sm_90a): the last stage's (B, h, w, C) float32 maps, channels
// last, resized (align corners) to each crop's target, un-mirrored where
// the crop was mirrored, background channel dropped, blurred (SciPy reflect
// Gaussian) and reduced to the first maximum of each channel.
//
// It replaces no TPU kernel: the JAX package runs this tail as plain XLA
// (tpupose/detectors/crop_keypoints.py:140, _tail_traced), and the port ran
// it as ~100 eager launches a crop.  Semantics are those of
// tpupose_torch/ops/crop_tail.py::crop_tails_plain, bit for bit:
//   * resize along H, then along W, each output from the two taps of its
//     row of _linear_matrix_align_corners: scale = (in - 1) / (out - 1),
//     src = o * scale and frac = src - floor(src) in float64, the weights
//     float32(1 - frac) and float32(frac), one weight (their float32 sum)
//     where both taps fall on the last sample, weight 1 at sample 0 where
//     either axis has one sample.  An output is fma(w_hi, x_hi, w_lo * x_lo):
//     the K-sequential FMA of a float32 matrix product, which is what the
//     CPU's matmul of the dense matrix gives;
//   * a mirrored crop reads column tw - 1 - x of the resized map;
//   * the blur: rows first (along H), then columns, each output
//     x_0 * t_0, then acc + x_k * t_k in tap order, every product and sum
//     rounded on its own (__fmul_rn, __fadd_rn, as blur_nms.cu), padding
//     by numpy's "symmetric" index, which repeats on maps narrower than the
//     radius;
//   * the first maximum in row-major order (NaN above every number, as
//     torch.argmax), its x, y, blurred value and value > thresh, written as
//     float32 rows (4, C - 1) a crop.
//
// Bound: operations.  The hand cell's request (8 crops of 64-192 px, C =
// 22, radius 10) reads 0.19 MB of maps and writes 2.7 KB, but resizes and
// blurs ~3 M pixels (of all 21 keypoint channels) with ~87 float32
// instructions a pixel that bit-equality keeps from fusing (41 a blur
// pass), ~0.26 G, ~8 us at the 33.5 T/s non-FMA rate.  The resized map
// never goes to device memory.  One block per (channel, crop) stages its
// channel's h x w source plane in shared memory once, then walks its target
// in tiles of kTileRows x kTileCols outputs: it computes the tile's rows
// and columns of taps (reflected, mirrored), the resized values of the
// tile with its halo of `radius` on each side from the plane, the H pass
// over them and the W pass, all in shared memory, and keeps each thread's
// running (value, index) best in registers.  A shared-memory tree reduces
// the block's bests, the lower index winning ties.  A tile's halo costs
// (kTileRows + 2r) x (kTileCols + 2r) resizes and kTileRows x (kTileCols +
// 2r) H-pass outputs for kTileRows x kTileCols outputs: 1.3x the H pass at
// radius 10.  The block's time is instructions and their latency: a blur
// output is a chain of 2r dependent adds, and a hand request has 168
// blocks, ~1.3 an SM.  So each thread keeps kRun outputs of one column in
// flight, in the H pass sliding down the column, each value it reads
// feeding every output whose window holds it; and radius 10 (sigma 2.5,
// the crop nets' default) has its own kernel, its loops unrolled and its
// taps read from the parameters' constant bank, where other radii read
// them from shared memory.  At the hand request (PERF.md): 0.18 ms with
// 256 threads, 32 x 64 tiles and one output a thread; ~0.085 ms as here.
// The items travel by value in the launch's parameters
// (CROP_TAIL_MAX_ITEMS a launch), so a request makes one launch and no
// host-to-device copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Must equal MAX_ITEMS, MAX_SIDE, MAX_RADIUS and MAX_PLANE in
// tpupose_torch/ops/crop_tail.py.
#define CROP_TAIL_MAX_ITEMS 64
#define CROP_TAIL_MAX_SIDE 2048
#define CROP_TAIL_MAX_RADIUS 48
#define CROP_TAIL_MAX_PLANE 16384

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kRun = 4;   // outputs of one column a thread keeps in flight
constexpr int kUnrolledRadius = 10;

struct Item {
  int th, tw, flip, pad;
};

struct Params {
  Item item[CROP_TAIL_MAX_ITEMS];
  float taps[2 * CROP_TAIL_MAX_RADIUS + 1];
};

// One output's two taps along an axis: sample indices and float32 weights.
struct Tap {
  int lo, hi;
  float wlo, whi;
};

// The source step of an axis of `in` samples resized to `out`.
__device__ __forceinline__ double align_corners_scale(int in, int out) {
  return in == 1 || out == 1
             ? 0.0
             : __ddiv_rn((double)(in - 1), (double)(out - 1));
}

__device__ __forceinline__ Tap align_corners_tap(int o, int in, int out,
                                                 double scale) {
  if (in == 1 || out == 1) return Tap{0, 0, 1.0f, 0.0f};
  const double src = __dmul_rn((double)o, scale);
  const int i0 = min(max((int)floor(src), 0), in - 1);
  const int i1 = min(i0 + 1, in - 1);
  const double frac = __dadd_rn(src, -(double)i0);
  const float w0 = __double2float_rn(__dadd_rn(1.0, -frac));
  const float w1 = __double2float_rn(frac);
  if (i0 == i1) return Tap{i0, i0, __fadd_rn(w0, w1), 0.0f};
  return Tap{i0, i1, w0, w1};
}

// numpy's "symmetric" pad: the source index of position p of an n-long
// axis, for any p (the reflection repeats with period 2n).
__device__ __forceinline__ int reflect(int p, int n) {
  const int period = 2 * n;
  int m = p % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

// Advance (row, col) of a flat index into rows of n by kThreads.
__device__ __forceinline__ void step(int& row, int& col, int n) {
  col += kThreads % n;
  row += kThreads / n;
  if (col >= n) {
    col -= n;
    ++row;
  }
}

// torch.argmax's order: NaN above every number, then the value; equal
// values go to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// kRadius >= 0: the blur's radius at compile time (its loops unrolled,
// the taps read from the parameters' constant bank); -1: `radius_arg`.
template <int kRadius>
__global__ void __launch_bounds__(kThreads)
crop_tail_kernel(const float* __restrict__ maps, float* __restrict__ out,
                 const Params p, int h, int w, int c, int radius_arg,
                 float thresh) {
  extern __shared__ __align__(16) int smem[];
  const int radius = kRadius >= 0 ? kRadius : radius_arg;
  const int halo_rows = kTileRows + 2 * radius;
  const int halo_cols = kTileCols + 2 * radius;
  const int n_taps = 2 * radius + 1;
  Tap* s_row = reinterpret_cast<Tap*>(smem);        // halo_rows
  Tap* s_col = s_row + halo_rows;                    // halo_cols
  float* s_plane = reinterpret_cast<float*>(s_col + halo_cols);  // h * w
  float* s_res = s_plane + h * w;          // halo_rows x halo_cols resized
  float* s_hp = s_res + halo_rows * halo_cols;  // kTileRows x halo_cols
  float* s_taps = s_hp + kTileRows * halo_cols;  // n_taps
  float* s_best = s_taps + n_taps;               // kThreads
  int* s_idx = reinterpret_cast<int*>(s_best + kThreads);  // kThreads
  const auto tap = [&](int k) {
    if constexpr (kRadius >= 0) return p.taps[k];
    return s_taps[k];
  };

  const int ch = blockIdx.x;
  const int item = blockIdx.y;
  const int th = p.item[item].th, tw = p.item[item].tw;
  const bool flip = p.item[item].flip != 0;
  const int tid = threadIdx.x;
  const double scale_h = align_corners_scale(h, th);
  const double scale_w = align_corners_scale(w, tw);

  const float* src = maps + (long long)item * h * w * c + ch;
  for (int i = tid; i < h * w; i += kThreads)
    s_plane[i] = __ldg(src + (long long)i * c);
  for (int k = tid; k < n_taps; k += kThreads) s_taps[k] = p.taps[k];

  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int r0 = 0; r0 < th; r0 += kTileRows) {
    for (int c0 = 0; c0 < tw; c0 += kTileCols) {
      const int nr = min(kTileRows, th - r0);
      const int nc = min(kTileCols, tw - c0);
      const int hr = nr + 2 * radius;   // the tile's rows with their halo
      const int hc = nc + 2 * radius;   // and its columns, the row stride
      const int runs = (nr + kRun - 1) / kRun;
      for (int j = tid; j < hr; j += kThreads) {
        Tap t = align_corners_tap(reflect(r0 - radius + j, th), h, th,
                                  scale_h);
        t.lo *= w;
        t.hi *= w;
        s_row[j] = t;
      }
      for (int q = tid; q < hc; q += kThreads) {
        int x = reflect(c0 - radius + q, tw);
        if (flip) x = tw - 1 - x;
        s_col[q] = align_corners_tap(x, w, tw, scale_w);
      }
      __syncthreads();
      // (j, q) = divmod(t, hc), stepped without a division
      int j = tid / hc, q = tid % hc;
#pragma unroll 4
      for (int t = tid; t < hr * hc; t += kThreads) {
        const Tap rt = s_row[j], ct = s_col[q];
        const float* a = s_plane + rt.lo;
        const float* b = s_plane + rt.hi;
        const float lo =
            __fmaf_rn(rt.whi, b[ct.lo], __fmul_rn(rt.wlo, a[ct.lo]));
        const float hi =
            __fmaf_rn(rt.whi, b[ct.hi], __fmul_rn(rt.wlo, a[ct.hi]));
        s_res[t] = __fmaf_rn(ct.whi, hi, __fmul_rn(ct.wlo, lo));
        step(j, q, hc);
      }
      __syncthreads();
      // H pass: a thread slides down one column over kRun outputs; each
      // resized value read feeds every output whose window holds it, in
      // that output's tap order.  The last run of a tile may read rows
      // below hr (inside s_res, stale) into outputs it then drops.
      int g = tid / hc;
      q = tid % hc;
      for (int t = tid; t < runs * hc; t += kThreads) {
        const float* x = s_res + g * kRun * hc + q;
        float acc[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int m = 0; m < n_taps + kRun - 1; ++m) {
          const float v = x[m * hc];
#pragma unroll
          for (int j = 0; j < kRun; ++j) {
            const int k = m - j;
            if (k >= 0 && k < n_taps) {
              const float prod = __fmul_rn(v, tap(k));
              acc[j] = k == 0 ? prod : __fadd_rn(acc[j], prod);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (g * kRun + j < nr) s_hp[(g * kRun + j) * hc + q] = acc[j];
        step(g, q, hc);
      }
      __syncthreads();
      // W pass: kRun outputs of one column a thread, kRun independent
      // sums in flight; rows past nr (inside s_hp, stale) are dropped.
      g = tid / nc;
      q = tid % nc;
      for (int t = tid; t < runs * nc; t += kThreads) {
        const float* x = s_hp + g * kRun * hc + q;
        float acc[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          acc[j] = __fmul_rn(x[j * hc], tap(0));
#pragma unroll
        for (int k = 1; k < n_taps; ++k) {
          const float t_k = tap(k);
#pragma unroll
          for (int j = 0; j < kRun; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j * hc + k], t_k));
        }
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int i = g * kRun + j;
          const int idx = (r0 + i) * tw + c0 + q;
          if (i < nr && better(acc[j], idx, best, best_i)) {
            best = acc[j];
            best_i = idx;
          }
        }
        step(g, q, nc);
      }
      // The next tile writes s_row, s_col and s_res before its first
      // barrier, and s_hp only after its second: the readers of s_hp above
      // have passed that first barrier by then.
    }
  }

  s_best[tid] = best;
  s_idx[tid] = best_i;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride &&
        better(s_best[tid + stride], s_idx[tid + stride], s_best[tid],
               s_idx[tid])) {
      s_best[tid] = s_best[tid + stride];
      s_idx[tid] = s_idx[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int keypoints = c - 1;
    float* row = out + (long long)item * 4 * keypoints + ch;
    const float score = s_best[0];
    const int i = s_idx[0];
    row[0] = (float)(i % tw);
    row[keypoints] = (float)(i / tw);
    row[2 * keypoints] = score;
    row[3 * keypoints] = score > thresh ? 1.0f : 0.0f;
  }
}

}  // namespace

// Shared memory a block needs, in bytes.
extern "C" int crop_tail_smem_bytes(int h, int w, int radius) {
  const int halo_rows = kTileRows + 2 * radius;
  const int halo_cols = kTileCols + 2 * radius;
  return (int)sizeof(Tap) * (halo_rows + halo_cols) +
         4 * (h * w + halo_rows * halo_cols + kTileRows * halo_cols +
              2 * radius + 1 + 2 * kThreads);
}

// maps: (n, h, w, c) float32, channels last; out: (n, 4, c - 1) float32;
// items: n rows of (target h, target w, flip) as int32; taps: the
// 2 * radius + 1 float32 taps of the blur.
extern "C" int crop_tail_launch(const float* maps, float* out,
                                const int* items, int n, int h, int w, int c,
                                const float* taps, int radius, float thresh,
                                void* stream) {
  if (n <= 0 || n > CROP_TAIL_MAX_ITEMS || h <= 0 || w <= 0 ||
      h * w > CROP_TAIL_MAX_PLANE || c < 2 || radius < 0 ||
      radius > CROP_TAIL_MAX_RADIUS)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < n; ++i) {
    const int* row = items + 3 * i;
    if (row[0] < 1 || row[0] > CROP_TAIL_MAX_SIDE || row[1] < 1 ||
        row[1] > CROP_TAIL_MAX_SIDE)
      return (int)cudaErrorInvalidValue;
    p.item[i] = Item{row[0], row[1], row[2] ? 1 : 0, 0};
  }
  for (int k = 0; k < 2 * radius + 1; ++k) p.taps[k] = taps[k];
  const int smem = crop_tail_smem_bytes(h, w, radius);
  // sigma 2.5, the crop nets' default, has its own unrolled kernel
  const auto kernel = radius == kUnrolledRadius
                          ? crop_tail_kernel<kUnrolledRadius>
                          : crop_tail_kernel<-1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(c - 1, n);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      maps, out, p, h, w, c, radius, thresh);
  return (int)cudaGetLastError();
}

extern "C" const char* crop_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
