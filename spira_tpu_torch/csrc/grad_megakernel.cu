// Fused forward + adjoint path-trace kernel for Hopper (sm_90a): the
// gradients of a sphere/small-triangle render, in one launch.
//
// Replaces spira_tpu/kernels/grad_megakernel.py:_grad_kernel (the Pallas
// kernel launched by _grad_launch through pl.pallas_call), and serves as
// the backward of render_flat_hybrid_grad, whose JAX backward is the XLA
// VJP of the fused twin (spira_tpu/kernels/megakernel.py:918-926).  Two
// modes over one device adjoint (adjoint.cuh:sample_vjp):
//
// * loss mode: each thread traces its pixel at spp (trace_pixel, as the
//   forward megakernel does), forms the residual against the target pixel,
//   adds res^2 to the loss (warp shuffle, one double atomicAdd per block)
//   and takes 2 res * cot_scale (cot_scale = 1 / (N grad_spp), N the
//   number of pixel-channels) as the cotangent of each replayed sample;
// * VJP mode: the cotangent is the incoming (H*W, 3) gradient times
//   cot_scale = 1 / grad_spp (the backward of a grad_spp-sample mean).
//
// Then each thread replays samples 0..grad_spp-1 of its pixel through the
// adjoint.  Work split: one thread per pixel, 128 threads a block.  A
// block stages the camera record and the scene tables in shared memory as
// the forward megakernel does, next to zeroed gradient accumulators of the
// same layout.  Scene-table cotangents go to those with shared-memory
// atomicAdd as each bounce is swept; the camera's stay in the thread's
// registers and are summed over the warp by shuffles at the end.  Each
// block then adds its accumulators to the global tables, one atomicAdd per
// non-zero field.  Float atomics sum in a different order on every run.
//
// What bounds it: fp32 ALU and transcendental work, as the forward: the
// replay traces every sample again and sweeps it backwards, about three
// times a forward sample's operations.  Device-memory traffic is the
// tables, the (H*W, 3) target or cotangent, and the gradient tables.  It
// runs far slower than that work (PERF.md): 96 registers and the 768-byte
// tape in local memory leave few warps per SM, and same-address
// shared-memory atomics (most lanes of a warp hit the same sphere)
// serialise.  The design does nothing about either yet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "adjoint.cuh"

namespace spira {

struct SharedAtomicAdd {
  __device__ __forceinline__ void operator()(float* p, float v) const {
    if (v != 0.0f) atomicAdd(p, v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    grad_megakernel(const float* __restrict__ cam_g,
                    const float* __restrict__ sph_g, int n_spheres,
                    const float* __restrict__ tri_g, int n_tris,
                    const float* __restrict__ pix, int loss_mode,
                    double* __restrict__ loss, float* __restrict__ dcam,
                    float* __restrict__ dsph, float* __restrict__ dtri,
                    int width, int height, int spp, int grad_spp,
                    int max_depth, uint32_t seed, float du, float dv,
                    float inv_spp, float cot_scale, int has_lens) {
  extern __shared__ float smem[];
  __shared__ double warp_loss[kThreads / 32];
  const int n_sph = n_spheres * kSphereFields;
  const int n_all = kCamFields + n_sph + n_tris * kTriFields;
  float* cam = smem;
  float* sph = cam + kCamFields;
  float* tri = sph + n_sph;
  float* gsm = smem + n_all;  // the cotangent accumulators, same layout
  float* gsph = gsm + kCamFields;
  float* gtri = gsph + n_sph;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    float x;
    if (i < kCamFields) {
      x = cam_g[i];
    } else if (i < kCamFields + n_sph) {
      x = sph_g[i - kCamFields];
    } else {
      x = tri_g[i - kCamFields - n_sph];
    }
    smem[i] = x;
    gsm[i] = 0.0f;
  }
  __syncthreads();

  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float gcam[kCamFields];
  for (int f = 0; f < kCamFields; ++f) gcam[f] = 0.0f;
  float sq = 0.0f;
  // Threads past the image's end stay for the warp reductions.
  if (idx < static_cast<int64_t>(width) * height) {
    const int row = static_cast<int>(idx / width);  // from the image bottom
    const int col = static_cast<int>(idx % width);
    const float row_f = static_cast<float>(row);
    const float col_f = static_cast<float>(col);
    const uint32_t pixel = static_cast<uint32_t>(idx);
    Vec3 gl;
    if (loss_mode) {
      const BruteIntersect intersect{sph, n_spheres, tri, n_tris};
      const Vec3 acc = trace_pixel(intersect, cam, has_lens != 0, pixel,
                                   row_f, col_f, seed, spp, max_depth, du, dv);
      const float rr = acc.x * inv_spp - pix[idx * 3 + 0];
      const float rg = acc.y * inv_spp - pix[idx * 3 + 1];
      const float rb = acc.z * inv_spp - pix[idx * 3 + 2];
      sq = rr * rr + rg * rg + rb * rb;
      gl = {2.0f * rr * cot_scale, 2.0f * rg * cot_scale,
            2.0f * rb * cot_scale};
    } else {
      gl = {pix[idx * 3 + 0] * cot_scale, pix[idx * 3 + 1] * cot_scale,
            pix[idx * 3 + 2] * cot_scale};
    }
    TapeEntry tape[kMaxTape];
    const SharedAtomicAdd add;
    for (int s = 0; s < grad_spp; ++s) {
      sample_vjp(cam, has_lens != 0, sph, gsph, n_spheres, tri, gtri, n_tris,
                 pixel, row_f, col_f, seed, s, max_depth, du, dv, gl, tape,
                 gcam, add);
    }
  }

  const int lane = threadIdx.x & 31;
  for (int f = 0; f < kCamFields; ++f) {
    const float v = warp_sum(gcam[f]);
    if (lane == 0 && v != 0.0f) atomicAdd(gsm + f, v);
  }
  const float wsq = warp_sum(sq);
  if (lane == 0) warp_loss[threadIdx.x >> 5] = static_cast<double>(wsq);
  __syncthreads();

  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    const float v = gsm[i];
    if (v == 0.0f) continue;
    if (i < kCamFields) {
      atomicAdd(dcam + i, v);
    } else if (i < kCamFields + n_sph) {
      atomicAdd(dsph + (i - kCamFields), v);
    } else {
      atomicAdd(dtri + (i - kCamFields - n_sph), v);
    }
  }
  if (loss_mode && threadIdx.x == 0) {
    double block = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_loss[w];
    atomicAdd(loss, block);
  }
}

}  // namespace spira

// Launches on `stream`; returns cudaGetLastError() (0 on success).  The
// outputs loss (1 double), dcam (20), dsph (S, 16) and dtri (T, 24) must
// be zeroed by the caller.  pix is the (H*W, 3) target in loss mode, the
// incoming cotangent in VJP mode.
extern "C" int spira_grad_render(
    const float* cam, const float* spheres, int n_spheres, const float* tris,
    int n_tris, const float* pix, int loss_mode, double* loss, float* dcam,
    float* dsph, float* dtri, int width, int height, int spp, int grad_spp,
    int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    float cot_scale, int has_lens, void* stream) {
  const int64_t n = static_cast<int64_t>(width) * height;
  const unsigned blocks = static_cast<unsigned>(
      (n + spira::kThreads - 1) / spira::kThreads);
  const size_t smem =
      2 * sizeof(float) *
      (spira::kCamFields + n_spheres * spira::kSphereFields +
       n_tris * spira::kTriFields);
  spira::grad_megakernel<<<blocks, spira::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      cam, spheres, n_spheres, tris, n_tris, pix, loss_mode, loss, dcam, dsph,
      dtri, width, height, spp, grad_spp, max_depth, seed, du, dv, inv_spp,
      cot_scale, has_lens);
  return static_cast<int>(cudaGetLastError());
}
