// Peak-rate probes for Hopper (sm_90a): how fast the card issues the
// float32 work the path kernels are made of.
//
// spira_vpu_peak replaces benchmarks/vpu_peak.py:kernel (kernel #9, the
// Pallas probe of the TPU's vector issue rate): each thread keeps kChains
// independent register chains, steps each `iters` times and writes the sum
// of its chains.  The step is chosen by `mode`:
//   0 separate:   fminf(x * 1.000001f + 1e-7f, 1e30f), the multiply and
//                 the add as two instructions, as every path kernel is
//                 built (-fmad=false): FMUL, FADD, FMNMX;
//   1 contracted: fminf(__fmaf_rn(x, 1.000001f, 1e-7f), 1e30f): FFMA,
//                 FMNMX (an explicit fmaf survives -fmad=false);
//   2-7:          one call of sqrtf, 1.0f / x, expf, logf, sinf or cosf as
//                 nvcc compiles it without fast-math (a multi-instruction
//                 sequence around the SFU, with a slow path for special
//                 inputs).  The chains are x <- sqrtf(x), 1 / x, expf(-x)
//                 (the negation is an operand modifier), logf(x) + 2 (one
//                 FADD beside the call), sinf(x), cosf(x): each stays
//                 finite and in the fast path from chain starts in 1..10
//                 (inputs in [1, 2) plus the chain index).
// The rate of mode 0 over the rate of a mode 2-7 chain is that operation's
// weight in ALU-instruction equivalents (utils/sol.py).
//
// spira_vpu_dtype replaces benchmarks/packet_profile.py:kernel (kernel
// #10, tier_vpu): each element steps acc = acc * c1 + x * c2 `steps`
// times from acc = x, in float32 or in bfloat16 pairs (__nv_bfloat162,
// __hmul2 / __hadd2: one rounding per operation, as JAX rounds each bf16
// operation).  x * c2 is the same in every step, so it is computed once
// before the loop (any compiler hoists it; the value is the same), and a
// step is 2 instructions: FMUL + FADD, or HMUL2 + HADD2 for two elements.
// JAX counts 2 flops a step too.
//
// Keeping the work live: every chain starts from an input read at run time
// and `iters` / `steps` are run-time arguments, so nothing folds; every
// chain feeds the stored sum.  The SASS (cuobjdump -sass of the built
// library, PERF.md) was read for the instruction counts above: mode 0's
// loop body is 3 instructions a chain-iteration, mode 1's 2, #10's 2 a
// step.
//
// What bounds them: the issue rate of the SM's four schedulers (one warp
// instruction a clock each, 128 float32 lanes a clock an SM), given enough
// independent work: 8 chains a thread for #9, one chain a thread over many
// resident warps for #10.  Memory traffic is one load and one store a
// thread.  A grid of the JAX tile's size (4,096 or 32,768 elements) fills
// a few of the 132 SMs and measures latency; the wrappers time it and a
// grid that fills every SM several times over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace spira {

constexpr int kChains = 8;
constexpr int kThreads = 256;

template <int kMode>
__device__ __forceinline__ float peak_step(float x) {
  if constexpr (kMode == 0) {
    return fminf(x * 1.000001f + 1e-7f, 1e30f);
  } else if constexpr (kMode == 1) {
    return fminf(__fmaf_rn(x, 1.000001f, 1e-7f), 1e30f);
  } else if constexpr (kMode == 2) {
    return sqrtf(x);
  } else if constexpr (kMode == 3) {
    return 1.0f / x;
  } else if constexpr (kMode == 4) {
    return expf(-x);
  } else if constexpr (kMode == 5) {
    return logf(x) + 2.0f;
  } else if constexpr (kMode == 6) {
    return sinf(x);
  } else {
    return cosf(x);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    vpu_peak(const float* __restrict__ x, float* __restrict__ out, int64_t n,
             int iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float xs[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) xs[k] = x0 + static_cast<float>(k);
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) xs[k] = peak_step<kMode>(xs[k]);
  }
  float acc = xs[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) acc = acc + xs[k];
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
    vpu_dtype_f32(const float* __restrict__ x, float* __restrict__ out,
                  int64_t n, int steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  const float xc = xv * 0.9999999f;
  float acc = xv;
  for (int s = 0; s < steps; ++s) acc = acc * 1.0000001f + xc;
  out[i] = acc;
}

// Two elements a thread; n is even (the wrapper checks).
__global__ void __launch_bounds__(kThreads)
    vpu_dtype_bf16(const float2* __restrict__ x, float2* __restrict__ out,
                   int64_t pairs, int steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= pairs) return;
  const float2 xf = x[i];
  const __nv_bfloat162 xv = __floats2bfloat162_rn(xf.x, xf.y);
  const __nv_bfloat162 c1 = __float2bfloat162_rn(1.0000001f);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(0.9999999f);
  const __nv_bfloat162 xc = __hmul2(xv, c2);
  __nv_bfloat162 acc = xv;
  for (int s = 0; s < steps; ++s) acc = __hadd2(__hmul2(acc, c1), xc);
  out[i] = __bfloat1622float2(acc);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace spira

// Kernel #9: x, out (n,) float32; mode 0-7 as above.  Launches on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a mode outside 0-7.
extern "C" int spira_vpu_peak(const float* x, float* out, long long n,
                              int iters, int mode, void* stream) {
  using namespace spira;
  if (n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned b = blocks_for(n);
  switch (mode) {
    case 0: vpu_peak<0><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 1: vpu_peak<1><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 2: vpu_peak<2><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 3: vpu_peak<3><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 4: vpu_peak<4><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 5: vpu_peak<5><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 6: vpu_peak<6><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    case 7: vpu_peak<7><<<b, kThreads, 0, st>>>(x, out, n, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel #10: x, out (n,) float32; bf16 != 0 steps bfloat16 pairs (n
// even).  Launches on `stream`; returns cudaGetLastError().
extern "C" int spira_vpu_dtype(const float* x, float* out, long long n,
                               int steps, int bf16, void* stream) {
  using namespace spira;
  if (n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int64_t pairs = n / 2;
    vpu_dtype_bf16<<<blocks_for(pairs), kThreads, 0, st>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(out),
        pairs, steps);
  } else {
    vpu_dtype_f32<<<blocks_for(n), kThreads, 0, st>>>(x, out, n, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
