// Hero-wavelength spectral path tracers for Hopper (sm_90a).
//
// spira_spectral_render replaces spira_tpu/kernels/spectral_fused.py:
// _spectral_kernel (the Pallas spectral megakernel over spheres and at most
// 32 triangles, launched by _launch_spectral through pl.pallas_call).
// spira_spectral_bvh_render replaces spira_tpu/kernels/spectral_bvh.py:
// _kernel (the same tracer over the packed-BVH walk of kernel #2).  Both
// run ray generation, four wavelength lanes, the spp x bounce loop,
// Chebyshev SPD evaluation, dispersion, Russian roulette and the film's
// CMF conversion in one launch, and write the mean XYZ as the flat
// (H*W, 3) float32 buffer, bottom-up; the wrappers convert to sRGB with a
// 3x3 product outside the kernel, as the JAX package does outside Pallas.
//
// Work split: 128 threads a block; the spectral megakernel runs one thread
// per pixel, the BVH kernel one thread per (pixel, sample) path, a pixel's
// samples summed in sample order by one thread (mesh_render.cuh:
// render_samples, as kernel #2).  A block copies the camera record, the
// sky's Chebyshev coefficients and the spectral sphere and triangle (or
// material) tables into shared memory; pair records and leaf rows stay in
// device memory and are read through __ldg (bvh.cuh), as in kernel #2.
// Both kernels share one tracer, spectral.cuh:trace_sample_spectral,
// templated on its intersector.
//
// What bounds it: fp32 ALU work, now dominated by the spectral shading: per
// bounce and lane two 12-term Clenshaw recurrences (emission, albedo), and
// per sample 12 for the sky and 8 expf per lane for the CMFs, on top of the
// RGB tracer's transcendentals; for the BVH kernel, the walk's dependent
// loads and warp divergence first, which the per-sample split and its
// 64-register budget answer as in kernel #2.  Device-memory traffic is a
// few KB of tables (plus the BVH tables, resident in L2) and 12 bytes per
// pixel.  Lane packing, Chebyshev evaluation on the tensor cores and
// warp-coherent traversal are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "bvh.cuh"
#include "mesh_render.cuh"
#include "spectral.cuh"

namespace spira {

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(128)
    spectral_megakernel(const float* __restrict__ cam_g,
                        const float* __restrict__ sky_g,
                        const float* __restrict__ sph_g, int n_spheres,
                        const float* __restrict__ tri_g, int n_tris,
                        float* __restrict__ out, int width, int height,
                        int spp, int max_depth, uint32_t seed, float du,
                        float dv, float inv_spp, float film_scale,
                        int has_lens) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* sky = cam + kCamFields;
  float* sph = sky + kSkyFields;
  float* tri = sph + n_spheres * kSphSpec;
  stage(cam, cam_g, kCamFields);
  stage(sky, sky_g, kSkyFields);
  stage(sph, sph_g, n_spheres * kSphSpec);
  stage(tri, tri_g, n_tris * kTriSpec);
  __syncthreads();

  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(width) * height) return;
  const int row = static_cast<int>(idx / width);  // from the image bottom
  const int col = static_cast<int>(idx % width);

  const SpectralBruteIntersect intersect{sph, n_spheres, tri, n_tris};
  const Vec3 acc = trace_pixel_spectral(
      intersect, cam, sky, has_lens != 0, static_cast<uint32_t>(idx),
      static_cast<float>(row), static_cast<float>(col), seed, spp, max_depth,
      du, dv, film_scale);
  out[idx * 3 + 0] = acc.x * inv_spp;
  out[idx * 3 + 1] = acc.y * inv_spp;
  out[idx * 3 + 2] = acc.z * inv_spp;
}

template <int kForm>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    spectral_bvh_megakernel(const float* __restrict__ cam_g,
                            const float* __restrict__ sky_g,
                            const float* __restrict__ sph_g, int n_spheres,
                            const float* __restrict__ mat_g, int n_mats,
                            const float4* __restrict__ pairs,
                            const float4* __restrict__ slots, int root,
                            float* __restrict__ out, int width, int height,
                            SampleSplit split, int max_depth, uint32_t seed,
                            float du, float dv, float inv_spp,
                            float film_scale, int has_lens) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* sky = cam + kCamFields;
  float* sph = sky + kSkyFields;
  float* mat = sph + n_spheres * kSphSpec;
  stage(cam, cam_g, kCamFields);
  stage(sky, sky_g, kSkyFields);
  stage(sph, sph_g, n_spheres * kSphSpec);
  stage(mat, mat_g, n_mats * kMatSpec);
  __syncthreads();

  const SpectralPackedIntersect<kForm> intersect{
      sph, n_spheres, mat, pairs, RowLeaves<kForm>{slots}, root};
  const auto sample = [&](int64_t pixel, int s) {
    const int row = static_cast<int>(pixel / width);  // from the bottom
    const int col = static_cast<int>(pixel % width);
    return trace_sample_spectral(
        intersect, cam, sky, has_lens != 0, static_cast<uint32_t>(pixel),
        static_cast<float>(row), static_cast<float>(col), seed, s, max_depth,
        du, dv, film_scale);
  };
  render_samples(split, static_cast<int64_t>(width) * height, sample, out,
                 inv_spp);
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace spira

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// sky: (3, 12) float32; spheres: (S, 33); tris: (T, 41), T <= 32.
extern "C" int spira_spectral_render(
    const float* cam, const float* sky, const float* spheres, int n_spheres,
    const float* tris, int n_tris, float* out, int width, int height,
    int spp, int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    float film_scale, int has_lens, void* stream) {
  using namespace spira;
  const size_t smem =
      sizeof(float) * (kCamFields + kSkyFields + n_spheres * kSphSpec +
                       n_tris * kTriSpec);
  spectral_megakernel<<<blocks_for(static_cast<int64_t>(width) * height),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, sky, spheres, n_spheres, tris, n_tris, out, width, height, spp,
      max_depth, seed, du, dv, inv_spp, film_scale, has_lens);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// mats: (M, 29) float32; pairs/tri_rows: the packed tables of
// accel/pairs.py; form_bw: 1 for Baldwin–Weber leaf rows, 0 for
// Möller–Trumbore.
extern "C" int spira_spectral_bvh_render(
    const float* cam, const float* sky, const float* spheres, int n_spheres,
    const float* mats, int n_mats, const float* pairs, const float* tri_rows,
    int root, int form_bw, float* out, int width, int height, int spp,
    int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    float film_scale, int has_lens, void* stream) {
  using namespace spira;
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * height);
  const size_t smem =
      sizeof(float) * (kCamFields + kSkyFields + n_spheres * kSphSpec +
                       n_mats * kMatSpec);
  const auto* p = reinterpret_cast<const float4*>(pairs);
  const auto* s = reinterpret_cast<const float4*>(tri_rows);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form_bw) {
    spectral_bvh_megakernel<kFormBW><<<blocks, kSplitThreads, smem, st>>>(
        cam, sky, spheres, n_spheres, mats, n_mats, p, s, root, out, width,
        height, split, max_depth, seed, du, dv, inv_spp, film_scale,
        has_lens);
  } else {
    spectral_bvh_megakernel<kFormMT><<<blocks, kSplitThreads, smem, st>>>(
        cam, sky, spheres, n_spheres, mats, n_mats, p, s, root, out, width,
        height, split, max_depth, seed, du, dv, inv_spp, film_scale,
        has_lens);
  }
  return static_cast<int>(cudaGetLastError());
}
