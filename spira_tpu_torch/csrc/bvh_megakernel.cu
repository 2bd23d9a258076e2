// Packed-BVH path tracer and nearest-hit query for Hopper (sm_90a).
//
// spira_bvh_megakernel_render replaces spira_tpu/kernels/bvh_megakernel.py:
// _kernel (the Pallas packet-BVH megakernel, launched by _launch through
// pl.pallas_call): ray generation, the spp x bounce loop, the sphere
// pre-pass and the BVH walk, scatter, Russian roulette and the mean over
// samples in one launch.  spira_bvh_intersect replaces
// _intersect_only_kernel: the nearest hit of a batch of rays.
// spira_bvh_mxu_render replaces the same Pallas kernel with mxu_leaf=True
// (its leaf visit _make_mxu_leaf_visit), kernel #2b: the same steps over a
// pair tree whose leaves are 128-triangle superleaf blocks, each block
// visit served by the whole warp and its lane groups pruned
// (superleaf.cuh:walk_blocks_warp); every thread of a warp traces its
// (pixel, sample) together with the others (mesh_render.cuh:
// trace_sample_warp), those without a path serving.  The first two share
// one walk, bvh.cuh:walk_packed, templated on its leaf visitor.
// spira_bvh_megakernel_render_counted is the counting build of the first
// (_kernel with counters=True): the same kernel over CountingIntersect,
// each thread counting its walks (bvh.cuh:WalkCounts), the block summing
// them once at the end; spira_bvh_mxu_render_counted the same for #2b.
//
// #2b on the H100 (PERF.md's kernel table): a block visited by one thread
// alone (RecordLeaves) holds the warp's other threads idle for up to 128
// lanes; served by the warp it ran about 5 times faster, and skipping the
// lane groups a ray does not enter took another quarter to a third off.
// Loading 2 or 4 records before testing lost (spills at 64 registers,
// fewer warps at 120-128), 4 blocks an SM lost, a 32-entry stack tied.
//
// Work split: the render kernels run one thread per (pixel, sample) path
// (mesh_render.cuh: a pixel's samples on consecutive threads of one block,
// summed in sample order by the first of them), the intersect kernel one
// thread per ray; 128 threads a block.  The render kernel copies the
// camera, sphere and material tables (a few hundred bytes) into shared
// memory; the pair records and leaf rows stay in device memory (bvh.cuh).
// The output is the flat (H*W, 3) float32 buffer, bottom-up, with kernel
// #1's PCG counters, so a scene renders the same on either kernel.
//
// What bounds it: dependent loads of the walk (each pop waits for a
// 64-byte record, each leaf for its triangles) and divergence between the
// threads of a warp, whose rays take different paths through the tree;
// then fp32 ALU work of the slab and triangle tests.  The tables fit in L2,
// so device-memory bandwidth is not the limit.  The split answers both: at
// spp 16 a warp holds the samples of 2 neighbouring pixels, whose camera
// rays walk the same records, so a primary walk runs without divergence
// and its loads serve the whole warp; the paths are short, 16 times as
// many threads at spp 16, so no pixel's run of samples holds up the last
// wave; and a budget of 64 registers keeps 8 blocks on an SM.  Packet or
// wide-BVH layouts, sorting secondary rays and TMA staging are later work.
//
// The intersect kernel is bound by the latency of one ray's walk: at the
// wavefront's shape (230,400 rays, 3-100% of them live) a launch lasts
// about two of the slowest warps' walks, whatever the number of live rays.
// So it loads a leaf's triangles 4 at a time (kIntersectBatch), one round
// of loads a batch instead of one a triangle, at 90 registers.  Measured
// and left out, on the H100 at that shape: compacting the live rays into a
// list (fewer warps, but each with 32 rays whose walks diverge, and too few
// warps to hide the latency), grouping them by direction octant, persistent
// warps fed by an atomic cursor, the stack in shared memory (no change),
// and fewer registers for more resident blocks (spills).
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

// Leaves: RowLeaves<kForm> (leaf rows) or RecordLeaves<kBatch> (superleaf
// blocks, each visited by one thread: #2b's serial visit, a variant of
// bench/superleaf.py).
template <class Leaves>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    bvh_megakernel(const float* __restrict__ cam_g,
                   const float* __restrict__ sph_g, int n_spheres,
                   const float* __restrict__ mat_g, int n_mats,
                   const float4* __restrict__ pairs, Leaves leaves, int root,
                   float* __restrict__ out, int width, int n_rows,
                   int row_start, int sample_offset, SampleSplit split,
                   int max_depth, uint32_t seed, float du, float dv,
                   float inv_spp, int has_lens) {
  const auto make = [&](const float* sph, const float* mat) {
    return TreeIntersect<Leaves>{sph, n_spheres, mat, pairs, leaves, root};
  };
  render_mesh(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
              n_rows, row_start, sample_offset, split, max_depth, seed, du,
              dv, inv_spp, has_lens);
}

// Add one thread's counts to totals[kNumCounts]: a warp sum of each count
// (a warp's 32-bit sums do not overflow at any frame a call can render),
// the warps' sums in shared memory, then one 64-bit atomicAdd per block and
// counter.  Every thread of the block calls it.
__device__ void add_block_counts(const WalkCounts& c,
                                 unsigned long long* __restrict__ totals) {
  __shared__ unsigned long long part[kNumCounts];
  if (threadIdx.x < kNumCounts) part[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t v[kNumCounts] = {c.pops,        c.pushes,
                                  c.traversals,  c.leaf_visits,
                                  c.leaf_tris,   c.leaf_visits_primary,
                                  c.hits};
#pragma unroll
  for (int k = 0; k < kNumCounts; ++k) {
    uint32_t s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&part[k], static_cast<unsigned long long>(s));
    }
  }
  __syncthreads();
  if (threadIdx.x < kNumCounts) atomicAdd(&totals[threadIdx.x],
                                          part[threadIdx.x]);
}

// Kernel #2 counting its work (CountingIntersect) into totals.
template <int kForm>
__global__ void __launch_bounds__(128)
    bvh_megakernel_counted(const float* __restrict__ cam_g,
                           const float* __restrict__ sph_g, int n_spheres,
                           const float* __restrict__ mat_g, int n_mats,
                           const float4* __restrict__ pairs,
                           RowLeaves<kForm> leaves, int root,
                           unsigned long long* __restrict__ totals,
                           float* __restrict__ out, int width, int height,
                           SampleSplit split, int max_depth, uint32_t seed,
                           float du, float dv, float inv_spp, int has_lens) {
  WalkCounts counts;
  const auto make = [&](const float* sph, const float* mat) {
    return CountingIntersect<RowLeaves<kForm>>{
        TreeIntersect<RowLeaves<kForm>>{sph, n_spheres, mat, pairs, leaves,
                                        root},
        &counts};
  };
  render_mesh(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
              height, 0, 0, split, max_depth, seed, du, dv, inv_spp,
              has_lens);
  add_block_counts(counts, totals);
}

// Kernel #2b: the walk over superleaf blocks, each block visit served by
// the whole warp (superleaf.cuh:walk_blocks_warp), every thread of the
// warp tracing together (mesh_render.cuh:trace_sample_warp); kBatch
// records a thread loaded before any is tested, a stack of kStack entries,
// __launch_bounds__(kSplitThreads, kMinBlocks); kPrune skips the lane
// groups whose box the ray does not enter before its best (a variant of
// bench/superleaf.py, over leaves.groups).
template <int kBatch, int kStack, int kMinBlocks, bool kPrune = false>
__global__ void __launch_bounds__(kSplitThreads, kMinBlocks)
    bvh_mxu_megakernel(const float* __restrict__ cam_g,
                       const float* __restrict__ sph_g, int n_spheres,
                       const float* __restrict__ mat_g, int n_mats,
                       const float4* __restrict__ pairs,
                       RecordLeaves<> leaves, int root,
                       float* __restrict__ out, int width, int n_rows,
                       int row_start, int sample_offset, SampleSplit split,
                       int max_depth, uint32_t seed, float du, float dv,
                       float inv_spp, int has_lens) {
  const auto make = [&](const float* sph, const float* mat) {
    return WarpBlockIntersect<kBatch, kStack, kPrune>{
        sph, n_spheres, mat, pairs, leaves, root};
  };
  render_mesh<true>(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
                    n_rows, row_start, sample_offset, split, max_depth, seed,
                    du, dv, inv_spp, has_lens);
}

// Kernel #2b counting its work (WarpCountingIntersect) into totals: the
// whole frame.
template <int kBatch, int kStack, bool kPrune>
__global__ void __launch_bounds__(kSplitThreads)
    bvh_mxu_megakernel_counted(const float* __restrict__ cam_g,
                               const float* __restrict__ sph_g, int n_spheres,
                               const float* __restrict__ mat_g, int n_mats,
                               const float4* __restrict__ pairs,
                               RecordLeaves<> leaves, int root,
                               unsigned long long* __restrict__ totals,
                               float* __restrict__ out, int width,
                               int height, SampleSplit split, int max_depth,
                               uint32_t seed, float du, float dv,
                               float inv_spp, int has_lens) {
  WalkCounts counts;
  const auto make = [&](const float* sph, const float* mat) {
    return WarpCountingIntersect<kBatch, kStack, kPrune>{
        WarpBlockIntersect<kBatch, kStack, kPrune>{sph, n_spheres, mat,
                                                   pairs, leaves, root},
        &counts};
  };
  render_mesh<true>(cam_g, sph_g, n_spheres, mat_g, n_mats, make, out, width,
                    height, 0, 0, split, max_depth, seed, du, dv, inv_spp,
                    has_lens);
  add_block_counts(counts, totals);
}

// #2b's shipped build: records a thread loaded at a time, the walk's
// stack, blocks an SM, the lane groups pruned (bench/superleaf.py
// --variants measured the others; PERF.md).
constexpr int kMxuBatch = 1;
constexpr int kMxuStack = kStackSize;
constexpr int kMxuMinBlocks = kSplitMinBlocks;
constexpr bool kMxuPrune = true;

// Launch #2b's build <kBatch, kStack, kMinBlocks, kPrune> over rows and
// samples as spira_bvh_mxu_render takes them; `groups`: the group boxes
// (accel/mxu.py:lane_group_bounds), read with kPrune only.
template <int kBatch, int kStack, int kMinBlocks, bool kPrune = false>
int launch_bvh_mxu(const float* cam, const float* spheres, int n_spheres,
                   const float* mats, int n_mats, const float* pairs,
                   const float* records, const int* offsets,
                   const float* coeff_pay, int root, float* out, int width,
                   int n_rows, int row_start, int sample_offset, int spp,
                   int max_depth, uint32_t seed, float du, float dv,
                   float inv_spp, int has_lens, void* stream,
                   const float* groups = nullptr) {
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * n_rows);
  bvh_mxu_megakernel<kBatch, kStack, kMinBlocks, kPrune>
      <<<blocks, kSplitThreads, mesh_smem_bytes(n_spheres, n_mats),
         static_cast<cudaStream_t>(stream)>>>(
          cam, spheres, n_spheres, mats, n_mats,
          reinterpret_cast<const float4*>(pairs),
          RecordLeaves<>{reinterpret_cast<const float4*>(records), offsets,
                         coeff_pay, reinterpret_cast<const float4*>(groups)},
          root, out, width, n_rows, row_start, sample_offset, split,
          max_depth, seed, du, dv, inv_spp, has_lens);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kThreads = 128;
// Leaf triangles kernel #3 loads at a time (bvh.cuh:visit_leaf).
constexpr int kIntersectBatch = 4;

// Kernel #3: one thread per ray; a dead ray (active[i] == 0) misses.
template <int kForm>
__global__ void __launch_bounds__(kThreads)
    bvh_intersect(const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const unsigned char* __restrict__ active, int n,
                  const float4* __restrict__ pairs,
                  const float4* __restrict__ slots, int root,
                  float* __restrict__ t_out, float* __restrict__ n_out,
                  int* __restrict__ mid_out, int* __restrict__ slot_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  TriHit h{kInf, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
  if (active == nullptr || active[i]) {
    const Vec3 o = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const Vec3 d = {dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
    walk_packed(pairs, RowLeaves<kForm, kIntersectBatch>{slots}, root, o, d,
                h);
  }
  t_out[i] = h.t;
  n_out[3 * i] = h.n.x;
  n_out[3 * i + 1] = h.n.y;
  n_out[3 * i + 2] = h.n.z;
  mid_out[i] = static_cast<int>(h.mid);
  if (slot_out != nullptr) slot_out[i] = h.slot;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace spira

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// form_bw: 1 for Baldwin–Weber leaf rows, 0 for Möller–Trumbore.
// The launch renders rows row_start .. row_start + n_rows - 1 of a frame
// `width` wide at samples sample_offset .. sample_offset + spp - 1 into
// out (n_rows * width, 3), each pixel's sum times inv_spp (du, dv: the
// whole frame's); offsets 0 and n_rows = height are the whole frame.
extern "C" int spira_bvh_megakernel_render(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* pairs, const float* tri_rows, int root,
    int form_bw, float* out, int width, int n_rows, int row_start,
    int sample_offset, int spp, int max_depth, uint32_t seed, float du,
    float dv, float inv_spp, int has_lens, void* stream) {
  using namespace spira;
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * n_rows);
  const size_t smem = mesh_smem_bytes(n_spheres, n_mats);
  const auto* p = reinterpret_cast<const float4*>(pairs);
  const auto* s = reinterpret_cast<const float4*>(tri_rows);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form_bw) {
    bvh_megakernel<RowLeaves<kFormBW>><<<blocks, kSplitThreads, smem, st>>>(
        cam, spheres, n_spheres, mats, n_mats, p, RowLeaves<kFormBW>{s}, root,
        out, width, n_rows, row_start, sample_offset, split, max_depth, seed,
        du, dv, inv_spp, has_lens);
  } else {
    bvh_megakernel<RowLeaves<kFormMT>><<<blocks, kSplitThreads, smem, st>>>(
        cam, spheres, n_spheres, mats, n_mats, p, RowLeaves<kFormMT>{s}, root,
        out, width, n_rows, row_start, sample_offset, split, max_depth, seed,
        du, dv, inv_spp, has_lens);
  }
  return static_cast<int>(cudaGetLastError());
}

// spira_bvh_megakernel_render counting its work: adds the frame's totals
// (pops, pushes, traversals, leaf_visits, leaf_tris, leaf_visits_primary,
// hits; bvh.cuh:WalkCounts) to totals[7], int64, which the caller zeroes.
extern "C" int spira_bvh_megakernel_render_counted(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* pairs, const float* tri_rows, int root,
    int form_bw, long long* totals, float* out, int width, int height,
    int spp, int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    int has_lens, void* stream) {
  using namespace spira;
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * height);
  const size_t smem = mesh_smem_bytes(n_spheres, n_mats);
  const auto* p = reinterpret_cast<const float4*>(pairs);
  const auto* s = reinterpret_cast<const float4*>(tri_rows);
  auto* tot = reinterpret_cast<unsigned long long*>(totals);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form_bw) {
    bvh_megakernel_counted<kFormBW><<<blocks, kSplitThreads, smem, st>>>(
        cam, spheres, n_spheres, mats, n_mats, p, RowLeaves<kFormBW>{s}, root,
        tot, out, width, height, split, max_depth, seed, du, dv, inv_spp,
        has_lens);
  } else {
    bvh_megakernel_counted<kFormMT><<<blocks, kSplitThreads, smem, st>>>(
        cam, spheres, n_spheres, mats, n_mats, p, RowLeaves<kFormMT>{s}, root,
        tot, out, width, height, split, max_depth, seed, du, dv, inv_spp,
        has_lens);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same path tracer over a pair tree whose leaves are superleaf blocks
// (accel/mxu.py:SuperleafBVH), kernel #2b: pairs (P, 16); the blocks' lane
// records (n_lanes, 24) and offsets (n_blocks + 1) of accel/mxu.py:
// LaneRecords; coeff_pay (B*8, 128); the blocks' group boxes (B*16, 4) of
// accel/mxu.py:lane_group_bounds; all float32 row-major; the rows and
// samples as spira_bvh_megakernel_render takes them.  The tree's depth is
// at most kMxuStack (the wrapper checks).
extern "C" int spira_bvh_mxu_render(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* pairs, const float* records, const int* offsets,
    const float* coeff_pay, const float* groups, int root, float* out,
    int width, int n_rows, int row_start, int sample_offset, int spp,
    int max_depth, uint32_t seed, float du, float dv, float inv_spp,
    int has_lens, void* stream) {
  using namespace spira;
  return launch_bvh_mxu<kMxuBatch, kMxuStack, kMxuMinBlocks, kMxuPrune>(
      cam, spheres, n_spheres, mats, n_mats, pairs, records, offsets,
      coeff_pay, root, out, width, n_rows, row_start, sample_offset, spp,
      max_depth, seed, du, dv, inv_spp, has_lens, stream, groups);
}

// spira_bvh_mxu_render of the whole frame counting its work: adds the
// frame's totals (bvh.cuh:WalkCounts; leaf_visits the blocks visited,
// leaf_tris the lanes tested: the real lanes of the groups entered) to
// totals[7], int64, which the caller zeroes.
extern "C" int spira_bvh_mxu_render_counted(
    const float* cam, const float* spheres, int n_spheres, const float* mats,
    int n_mats, const float* pairs, const float* records, const int* offsets,
    const float* coeff_pay, const float* groups, int root, long long* totals,
    float* out, int width, int height, int spp, int max_depth, uint32_t seed,
    float du, float dv, float inv_spp, int has_lens, void* stream) {
  using namespace spira;
  const SampleSplit split = sample_split(spp);
  const unsigned blocks =
      split_blocks(split, static_cast<int64_t>(width) * height);
  bvh_mxu_megakernel_counted<kMxuBatch, kMxuStack, kMxuPrune>
      <<<blocks, kSplitThreads, mesh_smem_bytes(n_spheres, n_mats),
         static_cast<cudaStream_t>(stream)>>>(
          cam, spheres, n_spheres, mats, n_mats,
          reinterpret_cast<const float4*>(pairs),
          RecordLeaves<>{reinterpret_cast<const float4*>(records), offsets,
                         coeff_pay, reinterpret_cast<const float4*>(groups)},
          root, reinterpret_cast<unsigned long long*>(totals), out, width,
          height, split, max_depth, seed, du, dv, inv_spp, has_lens);
  return static_cast<int>(cudaGetLastError());
}

// Nearest hit of n rays (origins, dirs: (n, 3) float32; active: (n,) bool,
// or null for every ray live).  Outputs t (1e20 on a miss), normal (n, 3),
// material id (-1 on a miss) and, when slot is not null, the winner's
// tri-row slot.
extern "C" int spira_bvh_intersect(const float* origins, const float* dirs,
                                   const unsigned char* active, int n,
                                   const float* pairs, const float* tri_rows,
                                   int root, int form_bw, float* t,
                                   float* normal, int* mid, int* slot,
                                   void* stream) {
  using namespace spira;
  if (n <= 0) return 0;
  const auto* p = reinterpret_cast<const float4*>(pairs);
  const auto* s = reinterpret_cast<const float4*>(tri_rows);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form_bw) {
    bvh_intersect<kFormBW><<<blocks_for(n), kThreads, 0, st>>>(
        origins, dirs, active, n, p, s, root, t, normal, mid, slot);
  } else {
    bvh_intersect<kFormMT><<<blocks_for(n), kThreads, 0, st>>>(
        origins, dirs, active, n, p, s, root, t, normal, mid, slot);
  }
  return static_cast<int>(cudaGetLastError());
}
