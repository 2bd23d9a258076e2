// Fused path-trace megakernel for Hopper (sm_90a), sphere and small
// triangle scenes, physical semantics, RGB.
//
// Replaces spira_tpu/kernels/megakernel.py:_kernel (the Pallas kernel,
// launched by _launch through pl.pallas_call).  Ray generation, the
// spp x bounce loop, intersection, scatter, Russian roulette and the mean
// over samples run in one launch; only the final HDR buffer is written.
//
// Work split: one thread per pixel, 128 threads a block.  A block copies
// the camera record and the scene tables (at most (S,16) + (32,24) floats,
// a few KB) into shared memory once; every thread then reads the same
// addresses, which shared memory broadcasts.  The Pallas kernel's (8,128)
// tiles and padding are not carried over: the output is the flat
// (H*W, 3) float32 buffer, bottom-up, written directly.
//
// What bounds it: fp32 ALU and transcendental work (sqrt, sin, cos, log
// per bounce), with almost no device-memory traffic: a few KB read, 12
// bytes per pixel written.  The design does nothing more about that yet:
// wgmma and TMA have nothing to feed here, and occupancy, register and
// divergence tuning are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).
// -fmad=false and no fast-math keep the rounding of the plain version.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace.cuh"

namespace spira {

__global__ void __launch_bounds__(128)
    megakernel(const float* __restrict__ cam_g,
               const float* __restrict__ sph_g, int n_spheres,
               const float* __restrict__ tri_g, int n_tris,
               float* __restrict__ out, int width, int height, int spp,
               int max_depth, uint32_t seed, float du, float dv,
               float inv_spp, int has_lens) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* sph = cam + kCamFields;
  float* tri = sph + n_spheres * kSphereFields;
  const int n_sph = n_spheres * kSphereFields;
  const int n_all = kCamFields + n_sph + n_tris * kTriFields;
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
  }
  __syncthreads();

  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(width) * height) return;
  const int row = static_cast<int>(idx / width);  // from the image bottom
  const int col = static_cast<int>(idx % width);

  const BruteIntersect intersect{sph, n_spheres, tri, n_tris};
  const Vec3 acc = trace_pixel(
      intersect, cam, has_lens != 0, static_cast<uint32_t>(idx),
      static_cast<float>(row), static_cast<float>(col), seed, spp, max_depth,
      du, dv);
  out[idx * 3 + 0] = acc.x * inv_spp;
  out[idx * 3 + 1] = acc.y * inv_spp;
  out[idx * 3 + 2] = acc.z * inv_spp;
}

}  // namespace spira

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int spira_megakernel_render(
    const float* cam, const float* spheres, int n_spheres, const float* tris,
    int n_tris, float* out, int width, int height, int spp, int max_depth,
    uint32_t seed, float du, float dv, float inv_spp, int has_lens,
    void* stream) {
  constexpr int kThreads = 128;
  const int64_t n = static_cast<int64_t>(width) * height;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem =
      sizeof(float) * (spira::kCamFields + n_spheres * spira::kSphereFields +
                       n_tris * spira::kTriFields);
  spira::megakernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cam, spheres, n_spheres, tris, n_tris, out, width, height, spp,
      max_depth, seed, du, dv, inv_spp, has_lens);
  return static_cast<int>(cudaGetLastError());
}
