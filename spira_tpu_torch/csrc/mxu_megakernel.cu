// Streaming superleaf path tracer and nearest-hit query for Hopper
// (sm_90a): every ray tests every 128-triangle block, with no tree.
//
// spira_mxu_megakernel_render replaces spira_tpu/kernels/mxu_megakernel.py:
// _kernel (kernel #7, launched by _launch through pl.pallas_call): ray
// generation, the spp x bounce loop, the sphere pre-pass whose nearest hit
// seeds best_t, the block stream, shading and the mean over samples in one
// launch.  spira_mxu_intersect replaces _raw_intersect_kernel (kernel #8):
// the block stream alone from best = 1e20, giving t, normal and material id.
//
// Work split: one thread per (pixel, sample) path (render) or per ray
// (intersect), 128 threads a block.  The render kernel stages the camera,
// sphere and material tables in shared memory (mesh_render.cuh:
// render_mesh) and traces through the shared tracer trace.cuh:trace_sample
// with superleaf.cuh's StreamIntersect, so its output and PCG stream are
// kernel #1's.  The
// coefficient tables stay in device memory and are read through __ldg; all
// threads of a warp read the same block lane at the same time, so every
// load is a broadcast.
//
// What bounds it: the block stream.  Each ray segment tests 128 lanes of
// every block, about 40 float operations and 22 loads a lane, and each
// warp reads all the tables (15.9 MB for the bunny's 777 blocks), which no
// cache below L2 holds.  The design does nothing more about that yet: a
// block staged in shared memory per CTA, or the contraction on the tensor
// cores (3xTF32 mma), is a later PR's work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "mesh_render.cuh"
#include "superleaf.cuh"
#include "trace.cuh"

namespace spira {

__global__ void __launch_bounds__(128)
    mxu_megakernel(const float* __restrict__ cam_g,
                   const float* __restrict__ sph_g, int n_spheres,
                   const float* __restrict__ mat_g, int n_mats,
                   const float* __restrict__ cuv,
                   const float* __restrict__ ct,
                   const float* __restrict__ cpay, int n_blocks,
                   float* __restrict__ out, int width, int height,
                   SampleSplit split, int max_depth, uint32_t seed, float du,
                   float dv, float inv_spp, int has_lens) {
  const auto make = [&](const float* sph, const float* mat) {
    return StreamIntersect{sph, n_spheres, mat, cuv, ct, cpay, n_blocks};
  };
  render_mesh(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
              height, 0, 0, split, max_depth, seed, du, dv, inv_spp,
              has_lens);
}

__global__ void __launch_bounds__(128)
    mxu_intersect(const float* __restrict__ origins,
                  const float* __restrict__ dirs, int n,
                  const float* __restrict__ cuv,
                  const float* __restrict__ ct,
                  const float* __restrict__ cpay, int n_blocks,
                  float* __restrict__ t_out, float* __restrict__ n_out,
                  int* __restrict__ mid_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  TriHit h{kInf, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
  const Vec3 o = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  const Vec3 d = {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  stream_blocks(cuv, ct, cpay, n_blocks, o, d, h);
  t_out[i] = h.t;
  n_out[3 * i] = h.n.x;
  n_out[3 * i + 1] = h.n.y;
  n_out[3 * i + 2] = h.n.z;
  mid_out[i] = static_cast<int>(h.mid);
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace spira

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// coeff_uv (B*8, 384), coeff_t and coeff_pay (B*8, 128): float32 row-major.
extern "C" int spira_mxu_megakernel_render(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* coeff_uv, const float* coeff_t,
    const float* coeff_pay, int n_blocks, float* out, int width, int height,
    int spp, int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    int has_lens, void* stream) {
  using namespace spira;
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * height);
  mxu_megakernel<<<blocks, kSplitThreads,
                   mesh_smem_bytes(n_spheres, n_mats),
                   static_cast<cudaStream_t>(stream)>>>(
      cam, spheres, n_spheres, mats, n_mats, coeff_uv, coeff_t, coeff_pay,
      n_blocks, out, width, height, split, max_depth, seed, du, dv, inv_spp,
      has_lens);
  return static_cast<int>(cudaGetLastError());
}

// Nearest hit of n rays (origins, dirs: (n, 3) float32) over every block:
// t (1e20 on a miss), normal (n, 3), material id (-1 on a miss).
extern "C" int spira_mxu_intersect(const float* origins, const float* dirs,
                                   int n, const float* coeff_uv,
                                   const float* coeff_t,
                                   const float* coeff_pay, int n_blocks,
                                   float* t, float* normal, int* mid,
                                   void* stream) {
  using namespace spira;
  if (n <= 0) return 0;
  mxu_intersect<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, n, coeff_uv, coeff_t, coeff_pay, n_blocks, t, normal,
      mid);
  return static_cast<int>(cudaGetLastError());
}
