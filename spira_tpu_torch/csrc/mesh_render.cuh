// The body of the RGB mesh render kernels (the packed-BVH kernel over row
// leaves or superleaf blocks, the streaming superleaf kernel): one thread
// per pixel over the shared tracer trace.cuh:trace_pixel, with the camera,
// sphere and material tables staged in shared memory.  Device-only: the
// intersectors it runs (bvh.cuh, superleaf.cuh) also build as host C++.
#pragma once

#include <cstddef>
#include <cstdint>

#include "bvh.cuh"
#include "trace.cuh"

namespace spira {

// The body of an RGB mesh render kernel (one thread per pixel): stage the
// camera, sphere and material tables in shared memory, then trace pixel
// idx through trace_pixel with the intersector `make(spheres, mats)`
// builds over the staged tables, and write the mean over samples.
template <class MakeIntersect>
__device__ __forceinline__ void render_mesh_pixel(
    const float* __restrict__ cam_g, const float* __restrict__ sph_g,
    int n_spheres, const float* __restrict__ mat_g, int n_mats,
    const MakeIntersect& make, float* __restrict__ out, int width, int height,
    int spp, int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    int has_lens) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* sph = cam + kCamFields;
  float* mat = sph + n_spheres * kSphereFields;
  const int n_sph = n_spheres * kSphereFields;
  const int n_all = kCamFields + n_sph + n_mats * kMatFields;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    float x;
    if (i < kCamFields) {
      x = cam_g[i];
    } else if (i < kCamFields + n_sph) {
      x = sph_g[i - kCamFields];
    } else {
      x = mat_g[i - kCamFields - n_sph];
    }
    smem[i] = x;
  }
  __syncthreads();

  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(width) * height) return;
  const int row = static_cast<int>(idx / width);  // from the image bottom
  const int col = static_cast<int>(idx % width);
  const Vec3 acc = trace_pixel(
      make(sph, mat), cam, has_lens != 0, static_cast<uint32_t>(idx),
      static_cast<float>(row), static_cast<float>(col), seed, spp, max_depth,
      du, dv);
  out[idx * 3 + 0] = acc.x * inv_spp;
  out[idx * 3 + 1] = acc.y * inv_spp;
  out[idx * 3 + 2] = acc.z * inv_spp;
}

// Shared memory of render_mesh_pixel's tables.
inline size_t mesh_smem_bytes(int n_spheres, int n_mats) {
  return sizeof(float) *
         (kCamFields + n_spheres * kSphereFields + n_mats * kMatFields);
}

}  // namespace spira
