// Fused path-trace megakernel for Hopper (sm_90a), sphere and small
// triangle scenes, physical semantics, RGB.
//
// Replaces spira_tpu/kernels/megakernel.py:_kernel (the Pallas kernel,
// launched by _launch through pl.pallas_call).  Ray generation, the
// spp x bounce loop, intersection, scatter, Russian roulette and the mean
// over samples run in one launch; only the final HDR buffer is written.
//
// Work split: one thread per pixel, 128 threads a block, blocks from the
// image's bottom row up.  A block copies the camera record and the scene
// tables (at most (S,16) + (32,24) floats, a few KB) into shared memory
// once; every thread then reads the same addresses, which shared memory
// broadcasts.  The Pallas kernel's (8,128) tiles and padding are not
// carried over: the output is the flat (H*W, 3) float32 buffer, bottom-up,
// written directly.  The sphere demo's warps rarely mix sky and hit pixels
// (0.7% of row-warps), so the mesh kernels' (pixel, sample) split
// (mesh_render.cuh) gains nothing here, and pixels drawn from a work
// counter lost too (PERF.md §6).
//
// Tables: a forward frame is two launches from one call.  gather_tables
// writes the records pack_tables builds, value for value, straight from
// the scene's and camera's arrays (scene_tables.cuh) into a scratch buffer;
// then megakernel renders from it.  The differentiable step passes the
// packed tables it differentiates and skips the gather.  The gather is a
// kernel of its own so that it adds nothing to the render body's registers
// (staged inside the render kernel it cost 8 registers and a block an SM).
//
// What bounds it: fp32 ALU and transcendental work (sqrt, sin, cos, log
// per bounce), with almost no device-memory traffic: a few KB read, 12
// bytes per pixel written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).
// -fmad=false and no fast-math keep the rounding of the plain version.

#include <cuda_runtime.h>

#include <cstdint>

#include "scene_tables.cuh"
#include "trace.cuh"

namespace spira {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    gather_tables(RgbTables tables, float* __restrict__ dst) {
  const int n = tables.size();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    dst[i] = tables.value(i);
  }
}

__global__ void __launch_bounds__(kThreads)
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

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace spira

// sizeof(spira::RgbTables), for the wrapper's check of its ctypes layout.
extern "C" int spira_megakernel_tables_bytes() {
  return static_cast<int>(sizeof(spira::RgbTables));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  With
// `gather` non-null, the tables are first gathered from the scene's arrays
// into `scratch` (gather->size() floats) and cam, spheres, n_spheres, tris
// and n_tris are ignored; else the packed tables are rendered as they are.
extern "C" int spira_megakernel_render(
    const spira::RgbTables* gather, float* scratch, const float* cam,
    const float* spheres, int n_spheres, const float* tris, int n_tris,
    float* out, int width, int height, int spp, int max_depth, uint32_t seed,
    float du, float dv, float inv_spp, int has_lens, void* stream) {
  using namespace spira;
  const auto s = static_cast<cudaStream_t>(stream);
  if (gather != nullptr) {
    gather_tables<<<blocks_for(gather->size()), kThreads, 0, s>>>(*gather,
                                                                 scratch);
    n_spheres = gather->geo.n_spheres;
    n_tris = gather->geo.n_tris;
    cam = scratch;
    spheres = cam + kCamFields;
    tris = spheres + n_spheres * kSphereFields;
  }
  const size_t smem = sizeof(float) * (kCamFields + n_spheres * kSphereFields +
                                       n_tris * kTriFields);
  megakernel<<<blocks_for(static_cast<int64_t>(width) * height), kThreads,
               smem, s>>>(cam, spheres, n_spheres, tris, n_tris, out, width,
                          height, spp, max_depth, seed, du, dv, inv_spp,
                          has_lens);
  return static_cast<int>(cudaGetLastError());
}
