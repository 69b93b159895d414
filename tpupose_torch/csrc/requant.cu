// The w8a8 requantize epilogue alone, over G int32 accumulators, for Hopper
// (sm_90a):
//   y   = sum_g acc_g * mult_g + bias
//   out = clip(rint(act(y)), lo, 127) as int8
// with act 0 none (y), 1 ReLU (max(y, 0)) or 2 PReLU (y < 0 ? y * slope_c
// : y, the slope applied in output-quant units, as csrc/conv_s8.cu does).
//
// Replaces the Pallas TPU kernel tpupose/ops/pallas/requant.py::
// requant_epilogue on the im2col route (quantize(conv7_impl="im2col")):
// there it is the epilogue of every int8 conv layer that is not a head,
// which runs as im2col + torch._int_mm and leaves an int32 accumulator;
// BODY_25's PReLU layers take act 2 and store in [-127, 127].  On the
// kernel route the same epilogue is fused into csrc/conv_s8.cu and
// csrc/conv7_s8.cu.  Semantics are those of tpupose_torch/ops/requant.py::
// epilogue_reference, bit for bit: each accumulator converts to float32
// with round-to-nearest, each product and sum rounds on its own in the
// plain version's order (group 0, + group 1, ..., + bias, then the slope's
// product), and __fmul_rn/__fadd_rn keep nvcc from contracting them into
// FMAs; rintf rounds half to even as torch.round does.
//
// Bound: device-memory bandwidth, 4 G bytes read and 1 byte written per
// element for a handful of float operations.  One pass over the data with
// coalesced loads; the plain version makes about seven passes of 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define REQUANT_MAX_GROUPS 4

namespace {

constexpr int kThreads = 256;
constexpr int kActRelu = 1;
constexpr int kActPrelu = 2;

struct Groups {
  const int32_t* acc[REQUANT_MAX_GROUPS];
  const float* mult[REQUANT_MAX_GROUPS];
};

__global__ void __launch_bounds__(kThreads)
requant_kernel(Groups groups, int G, const float* __restrict__ bias,
               const float* __restrict__ slope, int8_t* __restrict__ out,
               int n, int C, int act, float lo) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int c = i % C;
    float y = __fmul_rn(__int2float_rn(groups.acc[0][i]), groups.mult[0][c]);
    for (int g = 1; g < G; ++g)
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(groups.acc[g][i]),
                                 groups.mult[g][c]));
    y = __fadd_rn(y, bias[c]);
    if (act == kActRelu) y = fmaxf(y, 0.0f);
    else if (act == kActPrelu && y < 0.0f) y = __fmul_rn(y, slope[c]);
    y = fminf(fmaxf(rintf(y), lo), 127.0f);
    out[i] = (int8_t)(int)y;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// accs, mults: G device pointers each (host arrays), to n int32 (channels
// last, C channels) and to (C,) float32; bias: (C,) float32; slope: (C,)
// float32 for act 2, else unused; out: n int8.
extern "C" int requant_launch(const void* const* accs,
                              const void* const* mults, int G,
                              const float* bias, const float* slope,
                              int8_t* out, int n, int C, int act, float lo,
                              void* stream) {
  if (G < 1 || G > REQUANT_MAX_GROUPS || n <= 0 || C <= 0 || n % C != 0 ||
      act < 0 || act > kActPrelu || (act == kActPrelu && slope == nullptr))
    return (int)cudaErrorInvalidValue;
  Groups groups = {};
  for (int g = 0; g < G; ++g) {
    groups.acc[g] = (const int32_t*)accs[g];
    groups.mult[g] = (const float*)mults[g];
  }
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  requant_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      groups, G, bias, slope, out, n, C, act, lo);
  return (int)cudaGetLastError();
}

extern "C" const char* requant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
