// The w8a8 requantize epilogue alone, over G int32 accumulators, for Hopper
// (sm_90a):
//   out = clip(rint(max(sum_g acc_g * mult_g + bias, 0)), lo, 127) as int8
// with the max only when `relu` is set.
//
// Replaces the Pallas TPU kernel tpupose/ops/pallas/requant.py::
// requant_epilogue on the im2col route (quantize(conv7_impl="im2col")):
// there it is the epilogue of every int8 conv layer that is not a head,
// which runs as im2col + torch._int_mm and leaves an int32 accumulator.  On
// the kernel route the same epilogue is fused into csrc/conv_s8.cu and
// csrc/conv7_s8.cu.  Semantics are those of tpupose_torch/ops/requant.py::
// requant_epilogue_reference, bit for bit: each accumulator converts to
// float32 with round-to-nearest, each product and sum rounds on its own in
// the plain version's order (group 0, + group 1, ..., + bias), and
// __fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs; rintf
// rounds half to even as torch.round does.
//
// Bound: device-memory bandwidth, 4 G bytes read and 1 byte written per
// element for a handful of float operations.  One pass over the data with
// coalesced loads; the plain version makes about seven passes of 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define REQUANT_MAX_GROUPS 4

namespace {

constexpr int kThreads = 256;

struct Groups {
  const int32_t* acc[REQUANT_MAX_GROUPS];
  const float* mult[REQUANT_MAX_GROUPS];
};

__global__ void __launch_bounds__(kThreads)
requant_kernel(Groups groups, int G, const float* __restrict__ bias,
               int8_t* __restrict__ out, int n, int C, int relu, float lo) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int c = i % C;
    float y = __fmul_rn(__int2float_rn(groups.acc[0][i]), groups.mult[0][c]);
    for (int g = 1; g < G; ++g)
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(groups.acc[g][i]),
                                 groups.mult[g][c]));
    y = __fadd_rn(y, bias[c]);
    if (relu) y = fmaxf(y, 0.0f);
    y = fminf(fmaxf(rintf(y), lo), 127.0f);
    out[i] = (int8_t)(int)y;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// accs, mults: G device pointers each (host arrays), to n int32 (channels
// last, C channels) and to (C,) float32; bias: (C,) float32; out: n int8.
extern "C" int requant_launch(const void* const* accs,
                              const void* const* mults, int G,
                              const float* bias, int8_t* out, int n, int C,
                              int relu, float lo, void* stream) {
  if (G < 1 || G > REQUANT_MAX_GROUPS || n <= 0 || C <= 0 || n % C != 0)
    return (int)cudaErrorInvalidValue;
  Groups groups = {};
  for (int g = 0; g < G; ++g) {
    groups.acc[g] = (const int32_t*)accs[g];
    groups.mult[g] = (const float*)mults[g];
  }
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  requant_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      groups, G, bias, out, n, C, relu, lo);
  return (int)cudaGetLastError();
}

extern "C" const char* requant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
