// The adjoint path-trace kernels for Hopper (sm_90a): the gradients of a
// sphere/small-triangle render.
//
// Replaces spira_tpu/kernels/grad_megakernel.py:_grad_kernel (the Pallas
// kernel launched by _grad_launch through pl.pallas_call), and serves as
// the backward of render_flat_hybrid_grad, whose JAX backward is the XLA
// VJP of the fused twin (spira_tpu/kernels/megakernel.py:918-926).  One C
// entry, two modes:
//
// * VJP mode: grad_vjp alone, the cotangent being the incoming (H*W, 3)
//   gradient times cot_scale = 1 / grad_spp (the backward of a
//   grad_spp-sample mean);
// * loss mode: first grad_loss_forward, one thread per pixel, traces the
//   pixel at spp (trace_pixel, as the forward megakernel does), forms the
//   residual against the target pixel, adds res^2 to the loss (warp
//   shuffles, one double atomicAdd per block) and writes the cotangent
//   2 res cot_scale (cot_scale = 1 / (N grad_spp), N the number of
//   pixel-channels) into an (H*W, 3) scratch; then grad_vjp on the same
//   stream reads that scratch.  The Pallas kernel fuses the two because
//   on a TPU the residual stays in VMEM; here the forward then ran at the
//   adjoint's register count and occupancy, and the residual is a few
//   megabytes of L2 traffic.
//
// grad_vjp: one thread per replayed sample, thread index
// pixel * grad_spp + s, so a warp holds 32 / grad_spp pixels' samples
// (lanes of a pixel read the same cotangent).  Blocks are persistent: the
// grid is what fits on the card at once, and each block walks over
// 128-sample chunks, so the block's accumulators go to the global tables
// once per block, not once per chunk.  A block stages the camera record
// and the scene tables in shared memory as the forward megakernel does,
// next to zeroed gradient accumulators of the same layout and the tape:
// max_depth entries of kTapeWords words per thread, field-major with the
// thread index fastest, so a warp's tape accesses are free of bank
// conflicts and nothing is kept in local memory.  Scene-table cotangents
// go to shared-memory accumulators with atomicAdd as each hit is swept;
// most lanes of a warp hit the same record (the ground sphere, and at
// grad_spp 16 a warp holds 2 pixels), so the block keeps up to 32 copies
// of the accumulators, lane l adding into copy l % slots, an odd number
// of words apart: lanes adding to the same field of the same record then
// touch different words in different banks instead of serialising on one
// word.  `slots` is the most copies (a power of two) that leave as many
// blocks resident on an SM as one copy does (4 for the sphere demo at
// depth 4, where the registers allow 8 blocks; 32 at depth 16, where the
// tape allows 2); the C entry asks the occupancy queries once per device,
// table size and depth and keeps the answer.  The camera's cotangents
// stay in registers and are summed over the warp by shuffles after each
// chunk.  Each block finally sums its copies and adds them to the global
// tables, one atomicAdd per non-zero field.  Float sums run in a different order on every run, as
// the atomics land.
//
// What bounds it: fp32 ALU and transcendental work, as the forward: the
// replay traces every sample again and sweeps it backwards, about 1.6
// times a forward sample's operations (loss mode adds the forward).
// Device-memory traffic is the tables, the (H*W, 3) target or cotangent
// and scratch, and the gradient tables.  It runs well below that bound
// (PERF.md): within a warp the 16 samples of a pixel diverge after the
// first bounce, and at the 64-register budget that keeps 8 blocks an SM
// resident, a few registers spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "adjoint.cuh"

namespace spira {

constexpr int kThreads = 128;
// grad_vjp's register budget: __launch_bounds__ keeps this many blocks of
// kThreads resident on an SM (65,536 registers: at most 64 a thread)
constexpr int kVjpMinBlocks = 8;
// loss mode's forward runs megakernel.cu's trace_pixel: held to the same
// register count (56, 9 blocks an SM)
constexpr int kForwardMinBlocks = 9;
// copies of the gradient accumulators a VJP block keeps, at most: lane l
// adds into copy l % slots, slots the most (a power of two) that cost no
// resident block on an SM
constexpr int kSlots = 32;
// camera fields with a cotangent (the pad has none); a pinhole has 12
constexpr int kCamGrads = 19;
constexpr unsigned kFullMask = 0xffffffffu;
// dynamic shared memory a kernel takes without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  return v;
}

// The tape of a block's threads in shared memory: word w of entry b of
// thread i at tape[(b * kTapeWords + w) * blockDim.x + i].
struct SharedTape {
  float* base;  // the block's tape + threadIdx.x
  int stride;   // blockDim.x

  __device__ __forceinline__ void store(int b, const TapeEntry& e) const {
    float* p = base + b * kTapeWords * stride;
    const float w[kTapeWords] = {e.o.x, e.o.y, e.o.z, e.d.x,  e.d.y,
                                 e.d.z, e.tr,  e.tg,  e.tb,   e.t,
                                 e.scale, __int_as_float(e.prim)};
#pragma unroll
    for (int i = 0; i < kTapeWords; ++i) p[i * stride] = w[i];
  }

  __device__ __forceinline__ TapeEntry load(int b) const {
    const float* p = base + b * kTapeWords * stride;
    float w[kTapeWords];
#pragma unroll
    for (int i = 0; i < kTapeWords; ++i) w[i] = p[i * stride];
    TapeEntry e;
    e.o = {w[0], w[1], w[2]};
    e.d = {w[3], w[4], w[5]};
    e.tr = w[6];
    e.tg = w[7];
    e.tb = w[8];
    e.t = w[9];
    e.scale = w[10];
    e.prim = __float_as_int(w[11]);
    return e;
  }
};

// The adds of one lane go to its slot's copy of the accumulators (lane %
// slots), so lanes of a warp that add to the same field of the same record
// land on different words: with an odd copy stride, in different banks.
struct SlotAdd {
  int offset;  // the slot's copy, in words past the first copy

  __device__ __forceinline__ void operator()(float* p, float v) const {
    if (v != 0.0f) atomicAdd(p + offset, v);
  }
};

// Copies the camera record and the scene tables to smem[0..n_all).
__device__ __forceinline__ void stage_tables(float* smem,
                                             const float* cam_g,
                                             const float* sph_g, int n_sph,
                                             const float* tri_g, int n_all) {
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
}

__global__ void __launch_bounds__(kThreads, kForwardMinBlocks)
    grad_loss_forward(const float* __restrict__ cam_g,
                      const float* __restrict__ sph_g, int n_spheres,
                      const float* __restrict__ tri_g, int n_tris,
                      const float* __restrict__ target,
                      float* __restrict__ cot, double* __restrict__ loss,
                      int width, int height, int spp, int max_depth,
                      uint32_t seed, float du, float dv, float inv_spp,
                      float cot_scale, int has_lens) {
  extern __shared__ float smem[];
  __shared__ double warp_loss[kThreads / 32];
  const int n_sph = n_spheres * kSphereFields;
  const int n_all = kCamFields + n_sph + n_tris * kTriFields;
  stage_tables(smem, cam_g, sph_g, n_sph, tri_g, n_all);
  __syncthreads();
  const float* cam = smem;
  const float* sph = cam + kCamFields;
  const float* tri = sph + n_sph;

  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float sq = 0.0f;
  // Threads past the image's end stay for the warp reduction.
  if (idx < static_cast<int64_t>(width) * height) {
    const int row = static_cast<int>(idx / width);  // from the image bottom
    const int col = static_cast<int>(idx % width);
    const BruteIntersect intersect{sph, n_spheres, tri, n_tris};
    const Vec3 acc = trace_pixel(
        intersect, cam, has_lens != 0, static_cast<uint32_t>(idx),
        static_cast<float>(row), static_cast<float>(col), seed, spp,
        max_depth, du, dv);
    const float rr = acc.x * inv_spp - target[idx * 3 + 0];
    const float rg = acc.y * inv_spp - target[idx * 3 + 1];
    const float rb = acc.z * inv_spp - target[idx * 3 + 2];
    sq = rr * rr + rg * rg + rb * rb;
    cot[idx * 3 + 0] = 2.0f * rr * cot_scale;
    cot[idx * 3 + 1] = 2.0f * rg * cot_scale;
    cot[idx * 3 + 2] = 2.0f * rb * cot_scale;
  }
  const float wsq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) {
    warp_loss[threadIdx.x >> 5] = static_cast<double>(wsq);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double block = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_loss[w];
    atomicAdd(loss, block);
  }
}

__global__ void __launch_bounds__(kThreads, kVjpMinBlocks)
    grad_vjp(const float* __restrict__ cam_g,
             const float* __restrict__ sph_g, int n_spheres,
             const float* __restrict__ tri_g, int n_tris,
             const float* __restrict__ cot, float cot_scale,
             float* __restrict__ dcam, float* __restrict__ dsph,
             float* __restrict__ dtri, int width, int height, int grad_spp,
             int max_depth, uint32_t seed, float du, float dv, int has_lens,
             int slots) {
  extern __shared__ float smem[];
  const int n_sph = n_spheres * kSphereFields;
  const int n_all = kCamFields + n_sph + n_tris * kTriFields;
  const int stride = n_all | 1;  // odd: a lane's slot in its own bank
  // the cotangent accumulators: `slots` copies of the tables' layout
  float* gsm = smem + n_all;
  stage_tables(smem, cam_g, sph_g, n_sph, tri_g, n_all);
  for (int i = threadIdx.x; i < slots * stride; i += blockDim.x) {
    gsm[i] = 0.0f;
  }
  __syncthreads();
  const float* cam = smem;
  const float* sph = cam + kCamFields;
  const float* tri = sph + n_sph;
  float* gsph = gsm + kCamFields;
  float* gtri = gsph + n_sph;
  const SharedTape tape{gsm + slots * stride + threadIdx.x,
                        static_cast<int>(blockDim.x)};
  const SlotAdd add{(static_cast<int>(threadIdx.x) & (slots - 1)) * stride};
  const int n_cam = has_lens ? kCamGrads : 12;
  const int lane = threadIdx.x & 31;

  const int64_t n = static_cast<int64_t>(width) * height * grad_spp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t chunk = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       chunk < n; chunk += step) {
    const int64_t i = chunk + threadIdx.x;
    float gcam[kCamGrads];
#pragma unroll
    for (int f = 0; f < kCamGrads; ++f) gcam[f] = 0.0f;
    // Threads past the end stay for the warp reductions.
    if (i < n) {
      const int64_t pixel = i / grad_spp;
      const int s = static_cast<int>(i - pixel * grad_spp);
      const int row = static_cast<int>(pixel / width);  // from the bottom
      const int col = static_cast<int>(pixel % width);
      const Vec3 gl = {cot[pixel * 3 + 0] * cot_scale,
                       cot[pixel * 3 + 1] * cot_scale,
                       cot[pixel * 3 + 2] * cot_scale};
      sample_vjp(cam, has_lens != 0, sph, gsph, n_spheres, tri, gtri, n_tris,
                 static_cast<uint32_t>(pixel), static_cast<float>(row),
                 static_cast<float>(col), seed, s, max_depth, du, dv, gl,
                 tape, gcam, add);
    }
#pragma unroll
    for (int f = 0; f < kCamGrads; ++f) {
      if (f < n_cam) {
        const float v = warp_sum(gcam[f]);
        if (lane == 0 && v != 0.0f) atomicAdd(gsm + f, v);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    float v = 0.0f;
    for (int k = 0; k < slots; ++k) v += gsm[k * stride + i];
    if (v == 0.0f) continue;
    if (i < kCamFields) {
      atomicAdd(dcam + i, v);
    } else if (i < kCamFields + n_sph) {
      atomicAdd(dsph + (i - kCamFields), v);
    } else {
      atomicAdd(dtri + (i - kCamFields - n_sph), v);
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after this opt-in, or its launch fails).
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Bytes of the scene tables (camera, spheres, triangles).
size_t tables_bytes(int n_spheres, int n_tris) {
  return sizeof(float) * (kCamFields + n_spheres * kSphereFields +
                          n_tris * kTriFields);
}

// A grad_vjp block's shared memory with `slots` copies of the
// accumulators: the tables, the copies (an odd number of words apart), the
// tape.
size_t vjp_smem(size_t tables, int max_depth, int slots) {
  const size_t copy = sizeof(float) * ((tables / sizeof(float)) | 1);
  const size_t tape = sizeof(float) * kTapeWords * kThreads *
                      static_cast<size_t>(max_depth);
  return tables + slots * copy + tape;
}

// How grad_vjp launches on one device for one table size and depth: the
// SMs, the resident blocks an SM and the accumulator copies.  The
// occupancy queries that choose them run once per key, not per call.
struct VjpShape {
  int device;
  size_t tables;
  int max_depth;  // the key
  int sms, per_sm, slots;
};
constexpr int kShapeCache = 16;
VjpShape g_shapes[kShapeCache];
int g_n_shapes = 0;
std::mutex g_shapes_mutex;

cudaError_t vjp_shape(size_t tables, int max_depth, VjpShape* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(g_shapes_mutex);
  const int cached = g_n_shapes < kShapeCache ? g_n_shapes : kShapeCache;
  for (int i = 0; i < cached; ++i) {
    const VjpShape& c = g_shapes[i];
    if (c.device == device && c.tables == tables &&
        c.max_depth == max_depth) {
      *out = c;
      return cudaSuccess;
    }
  }
  VjpShape shape{device, tables, max_depth, 0, 0, 1};
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&shape.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(grad_vjp),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &shape.per_sm, grad_vjp, kThreads, vjp_smem(tables, max_depth, 1));
  }
  if (err != cudaSuccess) return err;
  if (shape.per_sm < 1) return cudaErrorInvalidConfiguration;
  // the most copies, up to kSlots, that cost no resident block
  for (int k = 2; k <= kSlots && vjp_smem(tables, max_depth, k) <=
                                     static_cast<size_t>(smem_max);
       k *= 2) {
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, grad_vjp, kThreads, vjp_smem(tables, max_depth, k));
    if (err != cudaSuccess) return err;
    if (fit < shape.per_sm) break;
    shape.slots = k;
  }
  g_shapes[g_n_shapes++ % kShapeCache] = shape;
  *out = shape;
  return cudaSuccess;
}

}  // namespace spira

// Launches on `stream`; returns the first CUDA error (0 on success).  The
// outputs loss (1 double), dcam (20), dsph (S, 16) and dtri (T, 24) must
// be zeroed by the caller.  pix is the (H*W, 3) target in loss mode, the
// incoming cotangent in VJP mode; scratch is an (H*W, 3) float buffer
// that loss mode writes the cotangent into (unused in VJP mode).
extern "C" int spira_grad_render(
    const float* cam, const float* spheres, int n_spheres, const float* tris,
    int n_tris, const float* pix, float* scratch, int loss_mode,
    double* loss, float* dcam, float* dsph, float* dtri, int width,
    int height, int spp, int grad_spp, int max_depth, uint32_t seed,
    float du, float dv, float inv_spp, float cot_scale, int has_lens,
    void* stream) {
  using spira::kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(width) * height;
  const size_t tables = spira::tables_bytes(n_spheres, n_tris);
  cudaError_t err;
  const float* cot = pix;
  if (loss_mode) {
    err = spira::allow_smem(
        reinterpret_cast<const void*>(spira::grad_loss_forward), tables);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks =
        static_cast<unsigned>((n + kThreads - 1) / kThreads);
    spira::grad_loss_forward<<<blocks, kThreads, tables, st>>>(
        cam, spheres, n_spheres, tris, n_tris, pix, scratch, loss, width,
        height, spp, max_depth, seed, du, dv, inv_spp, cot_scale, has_lens);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cot = scratch;  // already scaled
    cot_scale = 1.0f;
  }
  spira::VjpShape shape;
  err = spira::vjp_shape(tables, max_depth, &shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (n * grad_spp + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(shape.per_sm) * shape.sms;
  const unsigned blocks =
      static_cast<unsigned>(chunks < resident ? chunks : resident);
  spira::grad_vjp<<<blocks, kThreads,
                    spira::vjp_smem(tables, max_depth, shape.slots), st>>>(
      cam, spheres, n_spheres, tris, n_tris, cot, cot_scale, dcam, dsph, dtri,
      width, height, grad_spp, max_depth, seed, du, dv, has_lens,
      shape.slots);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a grad_vjp block takes with one copy of the
// accumulators (the least it runs with), for the wrapper's budget check.
extern "C" int spira_grad_smem(int n_spheres, int n_tris, int max_depth) {
  return static_cast<int>(
      spira::vjp_smem(spira::tables_bytes(n_spheres, n_tris), max_depth, 1));
}
