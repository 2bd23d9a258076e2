// Streaming superleaf path tracer and nearest-hit query for Hopper
// (sm_90a): every ray tests every real lane of every 128-triangle block,
// with no tree.
//
// spira_mxu_megakernel_render replaces spira_tpu/kernels/mxu_megakernel.py:
// _kernel (kernel #7, launched by _launch through pl.pallas_call): ray
// generation, the spp x bounce loop, the sphere pre-pass whose nearest hit
// seeds best_t, the block stream, shading and the mean over samples in one
// launch.  spira_mxu_intersect replaces _raw_intersect_kernel (kernel #8):
// the block stream alone from best = 1e20, giving t, normal and material id.
//
// Both read the coefficients as lane-major records (accel/mxu.py:
// LaneRecords, six float4s a lane) of the real lanes only: the TPU kernel
// contracts all 128 lanes because its matrix unit has that width, and a
// padding lane (all zero, det == 0) never hits, so skipping it keeps every
// bit.  The lane test (superleaf.cuh:lane_hit) sums the plain version's
// terms in its order, with IEEE 1/det and -fmad=false, so both kernels
// equal their plain versions to the bit.
//
// #8 (mxu_intersect): the control flow is uniform, since every thread
// streams every block, so a block of kIntersectThreads threads holds
// kIntersectRays rays a thread and stages the blocks' records in shared
// memory through a ring of kIntersectStages stages, each filled by one
// bulk copy (cp.async.bulk, completing on an mbarrier) issued by thread 0
// kIntersectStages - 1 blocks ahead; every thread reads a lane's record as
// a shared-memory broadcast and tests it against its rays, so one record
// load feeds kIntersectRays tests.
//
// #7 (mxu_megakernel): the paths reach the intersect at different bounces
// or not at all, so no barrier may sit in it.  Where the scene's records
// fit (the staged route: the 1,600-triangle mesh's 1,600 lanes take 154
// KB), each block of kRenderThreads threads copies them and the offsets
// into shared memory once, beside the camera, sphere and material tables,
// before its paths start; one block is resident on an SM.  Where they do
// not (the bunny's 72,960 lanes), the read-only route reads them as float4
// through __ldg, kRenderThreadsGlobal threads a block.  The wrapper picks
// the route by size (spira_mxu_render_smem).  The winner's payload is read
// from coeff_pay once a segment, only on a hit.  A warp holds the samples
// of two or more pixels, and its paths end at different bounces; with one
// sample a thread, the warp runs its lane loop once for each bounce any of
// its paths reaches (69% of the lanes busy on the mesh at spp 16).  So on
// the staged route a thread traces several samples (render_rounds) with
// path regeneration (mesh_render.cuh:render_mesh_regen): a thread whose
// path ends starts its next sample, the warp stepping together, and each
// sample's value waits in shared memory for the pixel's sum in sample
// order.
//
// What bounds them: the issue of the lane test, which utils/sol.py prices
// at 50 float instructions and an IEEE division a lane and ray.  The SASS
// of the lane loop (bench/superleaf.py --variants) takes about 70
// instructions a lane and ray in #8 and 74 in #7's staged route: the 50,
// the division's reciprocal, Newton steps and range check (about 9), the
// hit's two selects, and the record's six 16-byte loads and the loop
// (shared by #8's two rays).  So a kernel at full issue runs at about 70%
// of its bound; #7 loses more to lanes of warps whose paths ended.  The
// tensor cores are not used: the contraction has depth 6, and a 3xTF32
// split would change the bits the parity contract holds.
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

// #8's launch shape: threads a block, rays a thread, ring stages.  The
// fastest of the shapes bench/superleaf.py --variants measured on the
// bunny's 230,400 primary rays: 900 blocks, 6 or 7 on each SM (4 rays a
// thread spill, and 1,024-ray blocks leave SMs idle in the last wave).
constexpr int kIntersectThreads = 128;
constexpr int kIntersectRays = 2;
constexpr int kIntersectStages = 3;
// #7's threads a block on the staged route (one block an SM, so as many
// warps as the registers allow: 1,024 threads at 63 registers measured
// fastest) and on the read-only route.
constexpr int kRenderThreads = 1024;
constexpr int kRenderThreadsGlobal = 128;
// #7's samples a thread at least on the staged route, traced with path
// regeneration (mesh_render.cuh:sample_split's min_rounds).
constexpr int kRenderRounds = 4;

// ---- mbarriers and bulk copies (sm_90), as PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on bar (its one arrival a phase) and expect `bytes` of copies.
__device__ __forceinline__ void barrier_expect(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool barrier_try_wait(uint64_t* bar,
                                                 uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Copy `bytes` (a multiple of 16, 16-byte aligned ends) from device memory
// to shared memory; completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- kernel #7

// Floats of shared memory before the staged records: render_mesh's tables
// (mesh_smem_bytes), rounded up to whole float4s.
__host__ __device__ inline int staged_records_at(int n_spheres, int n_mats) {
  return (kCamFields + n_spheres * kSphereFields + n_mats * kMatFields + 3) &
         ~3;
}

// #7's samples a thread at least for spp on a route: on the staged route
// up to kRenderRounds but two threads a pixel at least, so that a frame
// still makes blocks enough to fill the SMs (measured at 640x360: spp 4
// fastest at 2, spp 16 at 4); on the read-only route one, as its
// 128-thread blocks measured no faster with regeneration.
inline int render_rounds(int spp, bool staged) {
  const int half = spp / 2;
  if (!staged || half < 1) return 1;
  return half < kRenderRounds ? half : kRenderRounds;
}

// Floats of shared memory before the sample values: the tables and, on
// the staged route, the records and the offsets, rounded up to whole
// float4s.
__host__ __device__ inline int values_at(int n_spheres, int n_mats,
                                         int n_lanes, int n_blocks,
                                         bool staged) {
  const int at = staged_records_at(n_spheres, n_mats);
  if (!staged) return at;
  return (at + n_lanes * 4 * kRecVecs + n_blocks + 1 + 3) & ~3;
}

// Dynamic shared memory of #7 on a route: values_at's and the split's
// sample values.
inline size_t render_smem_bytes(int n_spheres, int n_mats, int n_lanes,
                                int n_blocks, bool staged,
                                const SampleSplit& split) {
  return sizeof(float) *
         (static_cast<size_t>(
              values_at(n_spheres, n_mats, n_lanes, n_blocks, staged)) +
          3 * static_cast<size_t>(split.pixels) * split.spp);
}

template <int Threads, bool kStaged>
__global__ void __launch_bounds__(Threads)
    mxu_megakernel(const float* __restrict__ cam_g,
                   const float* __restrict__ sph_g, int n_spheres,
                   const float* __restrict__ mat_g, int n_mats,
                   const float4* __restrict__ rec_g,
                   const int* __restrict__ off_g, int n_lanes, int n_blocks,
                   const float* __restrict__ cpay, float* __restrict__ out,
                   int width, int height, SampleSplit split, int max_depth,
                   uint32_t seed, float du, float dv, float inv_spp,
                   int has_lens) {
  extern __shared__ float smem[];
  float4* rec_s = reinterpret_cast<float4*>(
      smem + staged_records_at(n_spheres, n_mats));
  int* off_s = reinterpret_cast<int*>(rec_s + n_lanes * kRecVecs);
  float* vals =
      smem + values_at(n_spheres, n_mats, n_lanes, n_blocks, kStaged);
  if constexpr (kStaged) {  // render_mesh_regen's barrier follows
    for (int i = threadIdx.x; i < n_lanes * kRecVecs; i += Threads) {
      rec_s[i] = __ldg(rec_g + i);
    }
    for (int i = threadIdx.x; i <= n_blocks; i += Threads) {
      off_s[i] = __ldg(off_g + i);
    }
  }
  const auto make = [&](const float* sph, const float* mat) {
    if constexpr (kStaged) {
      return RecordStream<SharedLoad>{sph,   n_spheres, mat, rec_s,
                                      off_s, n_blocks,  cpay};
    } else {
      return RecordStream<GlobalLoad>{sph,   n_spheres, mat, rec_g,
                                      off_g, n_blocks,  cpay};
    }
  };
  render_mesh_regen(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
                    height, split, max_depth, seed, du, dv, inv_spp, has_lens,
                    vals);
}

template <int Threads, bool kStaged>
int launch_render(const float* cam, const float* spheres, int n_spheres,
                  const float* mats, int n_mats, const float* records,
                  const int* offsets, int n_lanes, int n_blocks,
                  const float* coeff_pay, float* out, int width, int height,
                  int spp, int max_depth, uint32_t seed, float du, float dv,
                  float inv_spp, int has_lens, cudaStream_t stream,
                  int rounds = 0) {
  const SampleSplit split = sample_split(
      spp, Threads, rounds > 0 ? rounds : render_rounds(spp, kStaged));
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * height);
  const size_t smem = render_smem_bytes(n_spheres, n_mats, n_lanes,
                                        n_blocks, kStaged, split);
  const cudaError_t err = cudaFuncSetAttribute(
      mxu_megakernel<Threads, kStaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_megakernel<Threads, kStaged><<<blocks, Threads, smem, stream>>>(
      cam, spheres, n_spheres, mats, n_mats,
      reinterpret_cast<const float4*>(records), offsets, n_lanes, n_blocks,
      coeff_pay, out, width, height, split, max_depth, seed, du, dv, inv_spp,
      has_lens);
  return static_cast<int>(cudaGetLastError());
}

// A route's shared memory for these tables at spp, and what a block of
// its kernel may take: the device's opt-in maximum less the kernel's
// static shared memory.
template <int Threads, bool kStaged>
int smem_budget(int n_spheres, int n_mats, int n_lanes, int n_blocks,
                int spp, long long* need, long long* budget,
                int rounds = 0) {
  *need = static_cast<long long>(render_smem_bytes(
      n_spheres, n_mats, n_lanes, n_blocks, kStaged,
      sample_split(spp, Threads,
                   rounds > 0 ? rounds : render_rounds(spp, kStaged))));
  int device = 0;
  int optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, mxu_megakernel<Threads, kStaged>);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *budget = static_cast<long long>(optin) -
            static_cast<long long>(attr.sharedSizeBytes);
  return 0;
}

// ---- kernel #8

template <int Threads, int R, int Stages>
__global__ void __launch_bounds__(Threads)
    mxu_intersect(const float* __restrict__ origins,
                  const float* __restrict__ dirs, int n,
                  const float4* __restrict__ rec,
                  const int* __restrict__ off, int n_blocks, int max_lanes,
                  const float* __restrict__ cpay, float* __restrict__ t_out,
                  float* __restrict__ n_out, int* __restrict__ mid_out) {
  extern __shared__ float4 ring[];  // Stages x max_lanes records
  __shared__ uint64_t full[Stages];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (Threads * R) + threadIdx.x;
  LaneHits<R> h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t k = first + static_cast<int64_t>(i) * Threads;
    Vec3 o = {0.0f, 0.0f, 0.0f};
    Vec3 d = {0.0f, 0.0f, 0.0f};
    if (k < n) {  // a ray past n tests zeros and writes nothing
      o = {origins[3 * k], origins[3 * k + 1], origins[3 * k + 2]};
      d = {dirs[3 * k], dirs[3 * k + 1], dirs[3 * k + 2]};
    }
    h.ray[i] = lane_ray(o, d);
    h.t[i] = kInf;
    h.slot[i] = -1;
  }
  const int stage = max_lanes * kRecVecs;  // float4s a stage
  // Thread 0: fill stage s with block b's records.
  const auto fill = [&](int b, int s) {
    const int begin = __ldg(off + b);
    const uint32_t bytes = static_cast<uint32_t>(
        (__ldg(off + b + 1) - begin) * kRecVecs * sizeof(float4));
    barrier_expect(&full[s], bytes);
    if (bytes > 0) {
      bulk_copy(ring + s * stage, rec + static_cast<int64_t>(begin) * kRecVecs,
                bytes, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Stages; ++s) barrier_init(&full[s], 1);
    barrier_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages && s < n_blocks; ++s) fill(s, s);
  }
  for (int b = 0; b < n_blocks; ++b) {
    const int s = b % Stages;
    while (!barrier_try_wait(&full[s], (b / Stages) & 1)) {
    }
    visit_lanes<R>(ring + s * stage, __ldg(off + b + 1) - __ldg(off + b), b,
                   h, SharedLoad{});
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && b + Stages < n_blocks) fill(b + Stages, s);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t k = first + static_cast<int64_t>(i) * Threads;
    if (k >= n) continue;
    TriHit th{h.t[i], {0.0f, 0.0f, 0.0f}, -1.0f, h.slot[i]};
    if (th.slot >= 0) lane_payload(cpay, th.slot, th);
    t_out[k] = th.t;
    n_out[3 * k] = th.n.x;
    n_out[3 * k + 1] = th.n.y;
    n_out[3 * k + 2] = th.n.z;
    mid_out[k] = static_cast<int>(th.mid);
  }
}

template <int Threads, int R, int Stages>
int launch_intersect(const float* origins, const float* dirs, int n,
                     const float* records, const int* offsets, int n_blocks,
                     int max_lanes, const float* coeff_pay, float* t,
                     float* normal, int* mid, cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int64_t kPer = static_cast<int64_t>(Threads) * R;
  const auto blocks = static_cast<unsigned>((n + kPer - 1) / kPer);
  const size_t smem =
      sizeof(float4) * Stages * static_cast<size_t>(max_lanes) * kRecVecs;
  mxu_intersect<Threads, R, Stages><<<blocks, Threads, smem, stream>>>(
      origins, dirs, n, reinterpret_cast<const float4*>(records), offsets,
      n_blocks, max_lanes, coeff_pay, t, normal, mid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spira

// #7's dynamic shared memory for these tables at spp on a route (staged:
// 1 the staged route, 0 the read-only route) (*need) and what a block may
// take (*budget), in bytes; returns a CUDA error code.
extern "C" int spira_mxu_render_smem(int n_spheres, int n_mats, int n_lanes,
                                     int n_blocks, int spp, int staged,
                                     long long* need, long long* budget) {
  using namespace spira;
  if (staged) {
    return smem_budget<kRenderThreads, true>(n_spheres, n_mats, n_lanes,
                                             n_blocks, spp, need, budget);
  }
  return smem_budget<kRenderThreadsGlobal, false>(
      n_spheres, n_mats, n_lanes, n_blocks, spp, need, budget);
}

// Launches on `stream`; returns a CUDA error code (0 on success).
// records (n_lanes, 24) and offsets (n_blocks + 1): accel/mxu.py:
// LaneRecords; coeff_pay (n_blocks*8, 128) float32 row-major; staged: 1
// for the staged route, 0 for the read-only route (each must fit
// spira_mxu_render_smem's budget).
extern "C" int spira_mxu_megakernel_render(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* records, const int* offsets, int n_lanes,
    int n_blocks, const float* coeff_pay, int staged, float* out, int width,
    int height, int spp, int max_depth, uint32_t seed, float du, float dv,
    float inv_spp, int has_lens, void* stream) {
  using namespace spira;
  const auto st = static_cast<cudaStream_t>(stream);
  if (staged) {
    return launch_render<kRenderThreads, true>(
        cam, spheres, n_spheres, mats, n_mats, records, offsets, n_lanes,
        n_blocks, coeff_pay, out, width, height, spp, max_depth, seed, du,
        dv, inv_spp, has_lens, st);
  }
  return launch_render<kRenderThreadsGlobal, false>(
      cam, spheres, n_spheres, mats, n_mats, records, offsets, n_lanes,
      n_blocks, coeff_pay, out, width, height, spp, max_depth, seed, du, dv,
      inv_spp, has_lens, st);
}

// Nearest hit of n rays (origins, dirs: (n, 3) float32) over every block's
// real lanes: t (1e20 on a miss), normal (n, 3), material id (-1 on a
// miss).  max_lanes: the most real lanes of one block (a ring stage).
extern "C" int spira_mxu_intersect(const float* origins, const float* dirs,
                                   int n, const float* records,
                                   const int* offsets, int n_blocks,
                                   int max_lanes, const float* coeff_pay,
                                   float* t, float* normal, int* mid,
                                   void* stream) {
  using namespace spira;
  return launch_intersect<kIntersectThreads, kIntersectRays,
                          kIntersectStages>(
      origins, dirs, n, records, offsets, n_blocks, max_lanes, coeff_pay, t,
      normal, mid, static_cast<cudaStream_t>(stream));
}
