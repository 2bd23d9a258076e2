// The body of the mesh render kernels (the packed-BVH kernels over row
// leaves or superleaf blocks, RGB and spectral, and the streaming superleaf
// kernel) and of the spectral megakernel: one thread per (pixel, sample)
// path, each pixel's samples summed in sample order by one thread of its
// group.  The RGB body stages the
// camera, sphere and material tables in shared memory and traces through
// the shared tracer trace.cuh:trace_sample.
//
// The split (`SampleSplit`): a block of kSplitThreads threads takes
// `pixels` whole pixels, each as a group of `chunk` consecutive threads;
// thread j of a group traces samples j, chunk + j, ... (one a round, in
// `rounds` rounds) and leaves each sample's value in shared memory, where
// the group's first thread adds them, round by round, in sample order onto
// its running sum: acc + l_0 + l_1 + ..., the sum trace_pixel's loop forms,
// to the bit.  At spp <= kSplitThreads one round traces every sample
// (chunk = spp; 1 pixel of 128 threads at spp 128, 8 at spp 16, 42 at spp
// 3, 7 at spp 17 with 9 threads idle); past that the rounds share the
// samples evenly.  A pixel's PCG counters are functions of (pixel, sample),
// so the image is the one-thread-per-pixel kernel's.
//
// SampleSplit, sample_unit and fold_samples also build as host C++
// (tests/test_torch_counters.py runs the split on the CPU against
// trace_pixel); render_samples and render_mesh use shared memory and
// thread indices and are device-only.
#pragma once

#include <cstddef>
#include <cstdint>

#include "bvh.cuh"
#include "trace.cuh"

namespace spira {

constexpr int kSplitThreads = 128;  // threads a block of the split kernels
// The split kernels' register budget: __launch_bounds__(kSplitThreads,
// kSplitMinBlocks) keeps 8 blocks resident on an SM (at most 64 registers
// a thread), which measured faster than the compiler's own choice (#2 72
// registers and 7 blocks, #5 96 and 5, #4 96 and 5) though a few words
// spill.
constexpr int kSplitMinBlocks = 8;

struct SampleSplit {
  int spp;
  int chunk;   // threads a pixel (its group), <= kSplitThreads
  int pixels;  // pixels (groups) a block
  int rounds;  // samples a thread, at most
};

inline SampleSplit sample_split(int spp) {
  const int rounds = (spp + kSplitThreads - 1) / kSplitThreads;
  const int chunk = (spp + rounds - 1) / rounds;
  return {spp, chunk, kSplitThreads / chunk, rounds};
}

// Blocks a launch of the split over n_px pixels needs.
inline unsigned split_blocks(const SampleSplit& split, int64_t n_px) {
  return static_cast<unsigned>((n_px + split.pixels - 1) / split.pixels);
}

// Thread t of block `block`: its pixel, its place j in the pixel's group
// (j == 0 sums the group), and whether it has a pixel at all.
struct SampleUnit {
  int64_t pixel;
  int j;
  bool live;
};

__device__ __forceinline__ SampleUnit sample_unit(const SampleSplit& split,
                                                  int64_t block, int t,
                                                  int64_t n_px) {
  const int g = t / split.chunk;
  const int64_t pixel = block * split.pixels + g;
  return {pixel, t - g * split.chunk, g < split.pixels && pixel < n_px};
}

// acc + v[0] + v[1] + ... + v[n - 1], one channel array each, added left
// to right: the samples' order.
__device__ __forceinline__ Vec3 fold_samples(const float* x, const float* y,
                                             const float* z, int n,
                                             Vec3 acc) {
  for (int k = 0; k < n; ++k) {
    acc.x = acc.x + x[k];
    acc.y = acc.y + y[k];
    acc.z = acc.z + z[k];
  }
  return acc;
}

// The split over n_px pixels: `sample(pixel, s)` traces sample s of a
// pixel and returns its value; the mean over samples (sum * inv_spp) goes
// to out[3 * pixel ...].  Every thread of the block calls it.
template <class Sample>
__device__ __forceinline__ void render_samples(const SampleSplit& split,
                                               int64_t n_px,
                                               const Sample& sample,
                                               float* __restrict__ out,
                                               float inv_spp) {
  __shared__ float buf[3][kSplitThreads];  // one round's values, by channel
  const int t = threadIdx.x;
  const SampleUnit u = sample_unit(split, blockIdx.x, t, n_px);
  Vec3 acc = {0.0f, 0.0f, 0.0f};
  for (int r = 0; r < split.rounds; ++r) {
    const int s = r * split.chunk + u.j;
    if (u.live && s < split.spp) {
      const Vec3 l = sample(u.pixel, s);
      buf[0][t] = l.x;
      buf[1][t] = l.y;
      buf[2][t] = l.z;
    }
    __syncthreads();
    if (u.live && u.j == 0) {
      const int n = min(split.chunk, split.spp - r * split.chunk);
      acc = fold_samples(buf[0] + t, buf[1] + t, buf[2] + t, n, acc);
    }
    if (r + 1 < split.rounds) __syncthreads();
  }
  if (u.live && u.j == 0) {
    out[u.pixel * 3 + 0] = acc.x * inv_spp;
    out[u.pixel * 3 + 1] = acc.y * inv_spp;
    out[u.pixel * 3 + 2] = acc.z * inv_spp;
  }
}

// The body of an RGB mesh render kernel: stage the camera, sphere and
// material tables in shared memory, then trace each (pixel, sample) of the
// split through trace_sample with the intersector `make(spheres, mats)`
// builds over the staged tables, and write each pixel's mean.
template <class MakeIntersect>
__device__ __forceinline__ void render_mesh(
    const float* __restrict__ cam_g, const float* __restrict__ sph_g,
    int n_spheres, const float* __restrict__ mat_g, int n_mats,
    const MakeIntersect& make, float* __restrict__ out, int width, int height,
    const SampleSplit& split, int max_depth, uint32_t seed, float du,
    float dv, float inv_spp, int has_lens) {
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

  const auto intersect = make(sph, mat);
  const auto sample = [&](int64_t pixel, int s) {
    const int row = static_cast<int>(pixel / width);  // from the bottom
    const int col = static_cast<int>(pixel % width);
    return trace_sample(intersect, cam, has_lens != 0,
                        static_cast<uint32_t>(pixel), static_cast<float>(row),
                        static_cast<float>(col), seed, s, max_depth, du, dv);
  };
  render_samples(split, static_cast<int64_t>(width) * height, sample, out,
                 inv_spp);
}

// Shared memory of render_mesh's tables (the split's buffer is static).
inline size_t mesh_smem_bytes(int n_spheres, int n_mats) {
  return sizeof(float) *
         (kCamFields + n_spheres * kSphereFields + n_mats * kMatFields);
}

}  // namespace spira
