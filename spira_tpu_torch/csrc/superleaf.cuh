// Superleaf lane visits: rays against the real lanes of 128-triangle
// Plücker coefficient blocks (spira_tpu_torch/accel/mxu.py), the leaf test
// of the superleaf engines.
//
// Replaces the block visit of the JAX package's matrix-unit engines:
// spira_tpu/kernels/mxu_megakernel.py:_stream_blocks (the streaming kernel
// #7 and its nearest-hit query #8) and spira_tpu/kernels/bvh_megakernel.py:
// _make_mxu_leaf_visit (#2b, the leaf of the packet walk with
// mxu_leaf=True).  There a block is contracted against a whole ray tile on
// the TPU's matrix unit, (384, 8) x (8, 1024), all 128 lanes, and the
// winner of each column is picked by a lane argmin and a one-hot payload
// product.  Here a thread holds one ray (R rays in #8) and tests a block's
// real lanes in order, each lane read as one record of six float4s
// (accel/mxu.py:LaneRecords: the lane's 22 coefficients, two zeros):
//
//   for lane j = 0 .. real lanes - 1:
//     det, u_num, v_num = the coeff_uv rows 0-5 of columns j, 128 + j,
//                         256 + j against F_uv = [m, d] (m = o x d), left
//                         to right
//     t_num             = coeff_t rows 0-2 of column j against o, + row 6
//     idet = 1 / det; u, v, t = u_num, v_num, t_num * idet
//     hit: u >= 0, v >= 0, u + v <= 1, t > t_min, t < best, |det| > 1e-12
//
// The rows that meet a zero feature (coeff_uv rows 6-7 against F_uv's
// zeros, coeff_t rows 3-5 and 7 against F_o1's) are left out: they add a
// signed zero.  The plain version (kernels/bvh_megakernel.py:lane_hits)
// sums the same terms in the same order over all 128 lanes of the packed
// tables, and with -fmad=false and IEEE division the two agree to the
// bit.  The lanes a visit skips, past a block's last non-zero lane, are
// all zero: det == 0 gives idet = inf and u, v, t inf or NaN, which fail
// every comparison, so no skipped lane could have won.  A strict t < best
// in lane order keeps the lowest lane of equal hits, the JAX kernel's
// argmin rule; across blocks the same strict `<` holds.
//
// Kernel #2b visits a block with the whole warp, each thread testing a
// share of its lanes for one ray at a time, and skips the lane groups the
// ray does not enter (walk_blocks_warp, below).
//
// What bounds it: the lane test's ALU work, 50 float instructions and an
// IEEE division a lane and ray (utils/sol.py), which the TPU ran on its
// matrix unit.  A record is six 16-byte loads (a broadcast from shared
// memory in #7's staged route and in #8, where R rays share it), not the
// 22 scalar loads of the packed tables' strided columns; the payload is
// read once a segment or visit, for the winner only.  No tensor core is
// used: the contraction has depth 6, and a 3xTF32 split would change the
// bits the parity contract holds.
#pragma once

#include <cstdint>

#include "bvh.cuh"
#include "trace.cuh"

namespace spira {

constexpr int kSuperleaf = 128;  // SUPERLEAF: lanes (triangles) of a block
constexpr int kBlockRows = 8;    // BLOCK_ROWS: rows of a block in each table
constexpr int kRecVecs = 6;      // float4s of a lane record (LANE_RECORD = 24)
constexpr int kLaneGroup = 16;   // LANE_GROUP: lanes a group box bounds
constexpr int kGroups = kSuperleaf / kLaneGroup;  // group boxes a block

// A ray's lane features: m = o x d, then d and o.
struct LaneRay {
  float mx, my, mz, dx, dy, dz, ox, oy, oz;
};

__device__ __forceinline__ LaneRay lane_ray(Vec3 o, Vec3 d) {
  return {o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
          o.x * d.y - o.y * d.x, d.x, d.y, d.z, o.x, o.y, o.z};
}

// One lane's test on its record r (det rows 0-5, u_num rows 0-5, v_num
// rows 0-5, t_num rows 0-2 and 6, 2 zeros): the sums of the plain
// version's lane_hits in its order, IEEE 1/det and its six comparisons.
// Returns whether the lane hits below `best`, its distance in t.  The
// comparisons are joined with `&`, not `&&`: all six are computed, with no
// branch between them (the same result; 3-15% faster on the H100).
__device__ __forceinline__ bool lane_hit(const float4 (&r)[kRecVecs],
                                         const LaneRay& f, float best,
                                         float& t) {
  float det = r[0].x * f.mx;
  det = det + r[0].y * f.my;
  det = det + r[0].z * f.mz;
  det = det + r[0].w * f.dx;
  det = det + r[1].x * f.dy;
  det = det + r[1].y * f.dz;
  float un = r[1].z * f.mx;
  un = un + r[1].w * f.my;
  un = un + r[2].x * f.mz;
  un = un + r[2].y * f.dx;
  un = un + r[2].z * f.dy;
  un = un + r[2].w * f.dz;
  float vn = r[3].x * f.mx;
  vn = vn + r[3].y * f.my;
  vn = vn + r[3].z * f.mz;
  vn = vn + r[3].w * f.dx;
  vn = vn + r[4].x * f.dy;
  vn = vn + r[4].y * f.dz;
  float tn = r[4].z * f.ox + r[4].w * f.oy;
  tn = tn + r[5].x * f.oz;
  tn = tn + r[5].y;
  const float idet = 1.0f / det;
  const float uu = un * idet;
  const float vv = vn * idet;
  t = tn * idet;
  return (uu >= 0.0f) & (vv >= 0.0f) & (uu + vv <= 1.0f) & (t > kTMin) &
         (t < best) & (fabsf(det) > 1e-12f);
}

// How a visit reads records and offsets: SharedLoad from shared memory
// (or any memory, as a plain load), GlobalLoad through the read-only path.
struct SharedLoad {
  template <class T>
  __device__ __forceinline__ T operator()(const T* p) const {
    return *p;
  }
};
struct GlobalLoad {
  template <class T>
  __device__ __forceinline__ T operator()(const T* p) const {
    return __ldg(p);
  }
};

// R rays' features and running nearest hits: t, and the winner's slot
// (block * 128 + lane, -1: none).
template <int R>
struct LaneHits {
  LaneRay ray[R];
  float t[R];
  int slot[R];
};

// Lanes 0..n-1 of block `block`, their records from `rec`, against the R
// rays of h, lane by lane in order: each record is loaded once for all R
// rays, and a strict t < best keeps the lowest lane of equal hits.
template <int R, class Load>
__device__ __forceinline__ void visit_lanes(const float4* rec, int n,
                                            int block, LaneHits<R>& h,
                                            const Load& load) {
  const int first = block * kSuperleaf;
  for (int j = 0; j < n; ++j) {
    float4 r[kRecVecs];
#pragma unroll
    for (int k = 0; k < kRecVecs; ++k) r[k] = load(rec + j * kRecVecs + k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float t;
      if (lane_hit(r, h.ray[i], h.t[i], t)) {
        h.t[i] = t;
        h.slot[i] = first + j;
      }
    }
  }
}

// Every block's real lanes in block order (records rec, offsets off: block
// b's lanes are rec[off[b] .. off[b + 1] - 1]), against the R rays of h.
template <int R, class Load>
__device__ __forceinline__ void stream_records(const float4* rec,
                                               const int* off, int n_blocks,
                                               LaneHits<R>& h,
                                               const Load& load) {
  int begin = load(off);
  for (int b = 0; b < n_blocks; ++b) {
    const int end = load(off + b + 1);
    visit_lanes<R>(rec + begin * kRecVecs, end - begin, b, h, load);
    begin = end;
  }
}

// The winner's payload (coeff_pay rows 0-3 of its lane: normal, material
// id) into h; slot >= 0.
__device__ __forceinline__ void lane_payload(const float* __restrict__ cpay,
                                            int slot, TriHit& h) {
  const float* p = cpay +
                   static_cast<int64_t>(slot / kSuperleaf) * kBlockRows *
                       kSuperleaf +
                   slot % kSuperleaf;
  h.n = {__ldg(p), __ldg(p + kSuperleaf), __ldg(p + 2 * kSuperleaf)};
  h.mid = __ldg(p + 3 * kSuperleaf);
}

// Superleaf leaves of a pair tree (accel/mxu.py:SuperleafBVH): a leaf
// child's ptr is a block index (its count is not needed), whose real lanes
// are read through the read-only path.  The tables of #2b's block visit;
// called as a leaf visitor of bvh.cuh:walk_packed, one thread tests the
// block's lanes for its own ray (the serial visit, which the host tests
// and the variants of bench/superleaf.py run beside #2b's warp-wide one),
// kBatch records loaded before any is tested, and the payload is read once
// a visit, for its winner.
template <int kBatch = 1>
struct RecordLeaves {
  const float4* rec;
  const int* off;
  const float* cpay;
  // the blocks' group boxes (accel/mxu.py:lane_group_bounds), read by the
  // warp-wide visit when it prunes (kPrune, as #2b ships)
  const float4* groups = nullptr;

  __device__ void operator()(int ptr, int /*cnt*/, Vec3 o, Vec3 d,
                             TriHit& h) const {
    LaneHits<1> lh{{lane_ray(o, d)}, {h.t}, {-1}};
    const int begin = __ldg(off + ptr);
    const int n = __ldg(off + ptr + 1) - begin;
    const float4* r0 = rec + begin * kRecVecs;
    if (kBatch == 1) {
      visit_lanes<1>(r0, n, ptr, lh, GlobalLoad{});
    } else {
      for (int j0 = 0; j0 < n; j0 += kBatch) {
        float4 r[kBatch][kRecVecs];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (j0 + k < n) {
#pragma unroll
            for (int v = 0; v < kRecVecs; ++v) {
              r[k][v] = __ldg(r0 + (j0 + k) * kRecVecs + v);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          float t;
          if (j0 + k < n && lane_hit(r[k], lh.ray[0], lh.t[0], t)) {
            lh.t[0] = t;
            lh.slot[0] = ptr * kSuperleaf + j0 + k;
          }
        }
      }
    }
    if (lh.slot[0] >= 0) {
      h.t = lh.t[0];
      h.slot = lh.slot[0];
      lane_payload(cpay, h.slot, h);
    }
  }
};

// ---------------------------------------------------------------------------
// Kernel #2b's warp-wide block visit
//
// Each thread walks the pair tree for its own ray (bvh.cuh:walk_packed's
// steps, in its order), but a leaf child it reaches is not visited by the
// thread alone: it waits as the thread's pending block (at most two a pop,
// the nearer first), and the whole warp serves the pending blocks one at a
// time.  A serve takes the lowest thread with a block pending (a ballot)
// and sends its ray's features, its best t and the block to every thread
// (11 shuffles).  Threads 0-7 slab-test the block's group boxes (16 lanes
// a box) against that ray and best, and a ballot keeps the groups the ray
// enters before its best (group_mask).  The lanes of those groups are
// dealt out in lane order: thread i tests the kept lanes i, i + 32, ...
// against the ray and best, keeping its own nearest hit (strict <: its
// lowest lane of equal t).  Two warp reductions pick the serve's winner:
// the least t, as the bits of a positive float order as unsigned integers
// (a hit has t > kTMin > 0), then the least lane among the threads holding
// that t.  That is the lane the serial loop keeps, the lowest of equal
// hits, and its t to the bit: the tester computes lane_hit on the same
// record and features.  The owner takes it, then its next pending block.
// Blocks are served in each ray's own order, each with the best t its
// earlier blocks left, so a ray's hits, ties across blocks included (the
// earlier block wins), are the serial walk's.  The winner's payload is
// read once, after the walk.
//
// A skipped group cannot hold the winner: its box bounds its triangles
// padded outward (accel/mxu.py:lane_group_bounds, GROUP_PAD), so a ray
// that first meets it past its best meets every triangle in it past its
// best, by more than the rounding of either distance; a float lane t below
// the exact one by more than the padding (a ray within about 0.01 degrees
// of a triangle's plane) is the one case the padding does not cover.
// Bit-equal to the plain version on every frame the tests and
// chip_smoke.py hold.
//
// Why: one thread per (pixel, sample) path, a warp's rays diverge after
// the first bounce, and a serial visit of up to 128 lanes held the other
// 31 threads of the warp idle, at 2% of its bound (PERF.md).  Served
// by the warp, a visit is ceil(kept lanes / 32) rounds of coalesced record
// loads, whoever asks for it; threads whose path ended serve too.  A block
// packs several cut nodes (first fit), so a ray entering one of them
// enters few of the block's groups: on the bunny the lanes tested fall to
// about a third (PERF.md).
//
// Every thread of the warp calls the walk together (`live`: whether the
// thread has a ray), so the warp's primitives run over all 32 lanes.
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;

#ifdef __CUDACC__
// The warp's primitives over all of its 32 threads (the host tests supply
// their own with the same methods).
struct FullWarp {
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(0xffffffffu, p);
  }
  template <class T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ unsigned min(unsigned v) const {
    return __reduce_min_sync(0xffffffffu, v);
  }
};
#endif

// The walk's stack of records to visit, `N` entries in the thread's local
// memory (bvh.cuh:LocalStack has kStackSize): a tree at most N pair
// records deep.  #2b ships N = kStackSize, which the wrappers' depth check
// covers; bench/superleaf.py also times a 32-entry stack.
template <int N>
struct SizedStack {
  int s[N];

  __device__ __forceinline__ void put(int i, int v) { s[i] = v; }
  __device__ __forceinline__ int get(int i) const { return s[i]; }
};

// The position of the k-th set bit of mask (k counted from 0).
__device__ __forceinline__ int nth_bit(unsigned mask, int k) {
  for (int q = 0; q < k; ++q) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// This thread's share of one serve: lanes lane(), lane() + 32, ... below n
// of the records at rec against f, below t (which it lowers; `lane` takes
// the block lane of its nearest hit, -1: none), kBatch records loaded
// before any of them is tested.  With kPrune the shares run over the
// lanes of the groups whose bit is set in `groups` (16 lanes a group, in
// lane order), the others skipped.
template <int kBatch, bool kPrune, class Warp>
__device__ __forceinline__ void serve_share(const float4* rec, int n,
                                            unsigned groups,
                                            const LaneRay& f, float& t,
                                            int& lane, const Warp& w) {
  const int m = kPrune ? __popc(groups) * kLaneGroup : n;
  const auto lane_of = [&](int i) {
    if constexpr (kPrune) {
      return nth_bit(groups, i / kLaneGroup) * kLaneGroup + i % kLaneGroup;
    } else {
      return i;
    }
  };
  for (int i0 = w.lane(); i0 < m; i0 += kWarp * kBatch) {
    float4 r[kBatch][kRecVecs];
    int j[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      j[k] = i0 + kWarp * k < m ? lane_of(i0 + kWarp * k) : n;
      if (j[k] < n) {
#pragma unroll
        for (int v = 0; v < kRecVecs; ++v) {
          r[k][v] = __ldg(rec + j[k] * kRecVecs + v);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      float tt;
      if (j[k] < n && lane_hit(r[k], f, t, tt)) {
        t = tt;
        lane = j[k];
      }
    }
  }
}

// The lanes below n of the groups whose bit is set in `groups` (the last
// group holds the lanes past its first below n).
__device__ __forceinline__ int lanes_in(unsigned groups, int n) {
  const int last = n > 0 ? (n - 1) / kLaneGroup : 0;
  const int past = (groups >> last) & 1u ? (last + 1) * kLaneGroup - n : 0;
  return __popc(groups) * kLaneGroup - past;
}

// Which group boxes of block `block` the ray o, d (inv: its reciprocal
// direction, as the walk takes it) enters at a distance not past best,
// one bit a group: thread g < the block's groups slab-tests box g
// (bvh.cuh:slab_child, as the walk tests a child), then a ballot.  A
// box holds its 16 lanes' triangles padded outward, so a group whose bit
// is clear has no lane that could pass t < best.
template <class Warp>
__device__ __forceinline__ unsigned group_mask(const float4* groups,
                                               int block, int n, Vec3 o,
                                               Vec3 inv, float best,
                                               const Warp& w) {
  bool enter = false;
  if (w.lane() < (n + kLaneGroup - 1) / kLaneGroup) {
    const float4* g =
        groups + (static_cast<int64_t>(block) * kGroups + w.lane()) * 2;
    enter = slab_child(__ldg(g), __ldg(g + 1), o, inv, best).hit;
  }
  return w.ballot(enter);
}

// Serve every pending block of the warp's threads (pend0, then pend1),
// one block at a time with the whole warp, each against its owner's ray
// features f and best h.t; the owner takes the nearest hit below its best
// (h.t, h.slot = block * 128 + lane) and counts the visit and the lanes it
// tested.
// With kPrune a block's lanes are tested only in the groups whose box the
// owner's ray enters before its best (group_mask).
template <int kBatch, bool kPrune, class Warp, class Count>
__device__ __forceinline__ void serve_blocks(const RecordLeaves<>& leaves,
                                             const LaneRay& f, int& pend0,
                                             int& pend1, TriHit& h,
                                             Count& count, const Warp& w) {
  for (unsigned want = w.ballot(pend0 >= 0); want != 0;
       want = w.ballot(pend0 >= 0)) {
    const int owner = __ffs(want) - 1;
    const int block = w.shfl(pend0, owner);
    const LaneRay g = {w.shfl(f.mx, owner), w.shfl(f.my, owner),
                       w.shfl(f.mz, owner), w.shfl(f.dx, owner),
                       w.shfl(f.dy, owner), w.shfl(f.dz, owner),
                       w.shfl(f.ox, owner), w.shfl(f.oy, owner),
                       w.shfl(f.oz, owner)};
    float t = w.shfl(h.t, owner);
    const int begin = __ldg(leaves.off + block);
    const int n = __ldg(leaves.off + block + 1) - begin;
    unsigned groups = 0xffffffffu;
    if constexpr (kPrune) {
      const Vec3 o = {g.ox, g.oy, g.oz};
      const Vec3 inv = {fabsf(g.dx) > 1e-12f ? 1.0f / g.dx : 1e12f,
                        fabsf(g.dy) > 1e-12f ? 1.0f / g.dy : 1e12f,
                        fabsf(g.dz) > 1e-12f ? 1.0f / g.dz : 1e12f};
      groups = group_mask(leaves.groups, block, n, o, inv, t, w);
    }
    int lane = -1;
    serve_share<kBatch, kPrune>(leaves.rec + begin * kRecVecs, n, groups, g,
                                t, lane, w);
    const unsigned key = lane >= 0 ? __float_as_uint(t) : 0xffffffffu;
    const unsigned least = w.min(key);
    const unsigned first =
        w.min(key == least ? static_cast<unsigned>(lane) : 0xffffffffu);
    if (w.lane() == owner) {
      count.leaf(kPrune ? lanes_in(groups, n) : n);
      if (least != 0xffffffffu) {
        h.t = __uint_as_float(least);
        h.slot = block * kSuperleaf + static_cast<int>(first);
      }
      pend0 = pend1;
      pend1 = -1;
    }
  }
}

// The nearest block hit below h.t over the whole superleaf tree, every
// thread of the warp together (`live`: the thread has a ray o, d; the
// others serve): walk_packed's pops, slab tests, order and pushes, each
// leaf child served by the warp (serve_blocks) before the thread's next
// pop.  h.slot comes in as -1; the winner's payload (normal, material id)
// is read once, at the end.
template <int kBatch, bool kPrune = false, class Warp, class Count,
          class Stack>
__device__ __forceinline__ void walk_blocks_warp(
    const float4* __restrict__ pairs, const RecordLeaves<>& leaves, int root,
    Vec3 o, Vec3 d, bool live, TriHit& h, Count& count, Stack& stack,
    const Warp& w) {
  const Vec3 inv = {fabsf(d.x) > 1e-12f ? 1.0f / d.x : 1e12f,
                    fabsf(d.y) > 1e-12f ? 1.0f / d.y : 1e12f,
                    fabsf(d.z) > 1e-12f ? 1.0f / d.z : 1e12f};
  const LaneRay f = lane_ray(o, d);
  int sp = 0;
  if (live) {
    stack.put(sp++, root);
    count.walk();
  }
  int pend0 = -1, pend1 = -1;
  while (w.any(sp > 0)) {
    if (sp > 0) {
      const float4* r = pairs + static_cast<int64_t>(stack.get(--sp)) * 4;
      count.pop();
      const float best = h.t;
      const Child c0 = slab_child(__ldg(r), __ldg(r + 1), o, inv, best);
      const Child c1 = slab_child(__ldg(r + 2), __ldg(r + 3), o, inv, best);
      const bool near0 = c0.tn <= c1.tn;
      const Child cn = near0 ? c0 : c1;
      const Child cf = near0 ? c1 : c0;
      if (cn.hit && cn.cnt > 0) pend0 = cn.ptr;
      if (cf.hit && cf.cnt > 0) (pend0 < 0 ? pend0 : pend1) = cf.ptr;
      if (cf.hit && cf.cnt == 0) {
        count.push();
        stack.put(sp++, cf.ptr);
      }
      if (cn.hit && cn.cnt == 0) {
        count.push();
        stack.put(sp++, cn.ptr);
      }
    }
    serve_blocks<kBatch, kPrune>(leaves, f, pend0, pend1, h, count, w);
  }
  if (h.slot >= 0) lane_payload(leaves.cpay, h.slot, h);
}

// The intersector of #2b: spheres first (their nearest hit seeds best_t),
// then walk_blocks_warp over the superleaf tree, kBatch records a thread
// loaded before any is tested, the walk's stack kStack entries.  Every
// thread of the warp calls it together; `live` says whether the thread's
// ray o, d is asked for (a thread without one gets a miss and serves the
// others).  `intersect` counts the walk into `count` (NoCount or
// WalkCounts).
template <int kBatch, int kStack, bool kPrune = false>
struct WarpBlockIntersect {
  const float* spheres;
  int n_spheres;
  const float* mats;
  const float4* pairs;
  RecordLeaves<> leaves;
  int root;

#ifdef __CUDACC__
  template <class Count>
  __device__ SurfaceHit intersect(Vec3 o, Vec3 d, bool live,
                                  Count& count) const {
    float best_t = kInf;
    int sphere = -1;
    if (live) sphere = nearest_sphere(spheres, n_spheres, o, d, best_t);
    TriHit th{best_t, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
    SizedStack<kStack> stack;
    walk_blocks_warp<kBatch, kPrune>(pairs, leaves, root, o, d, live, th,
                                     count, stack, FullWarp{});
    if (!live) {
      SurfaceHit miss;
      miss.hit = false;
      return miss;
    }
    return resolve_hit<kSphereFields, kMatFields>(spheres, sphere, mats, th,
                                                  o, d);
  }

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d, bool live) const {
    NoCount none;
    return intersect(o, d, live, none);
  }
#endif
};

// WarpBlockIntersect counting its walks into *counts (bvh.cuh:WalkCounts:
// leaf_visits the blocks served for this thread, leaf_tris the lanes
// tested for it: with kPrune the real lanes of the groups its ray enters),
// and the segments that hit a surface; takes the bounce index.
template <int kBatch, int kStack, bool kPrune>
struct WarpCountingIntersect {
  WarpBlockIntersect<kBatch, kStack, kPrune> tree;
  WalkCounts* counts;

#ifdef __CUDACC__
  __device__ void begin_bounce(int b) const { counts->bounce = b; }

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d, bool live) const {
    const SurfaceHit h = tree.intersect(o, d, live, *counts);
    if (live && h.hit) ++counts->hits;
    return h;
  }
#endif
};

// Spheres first (their nearest hit seeds best_t), then every block's real
// lanes from records read by Load (shared memory or the read-only path;
// the offsets too), then the winner's payload from coeff_pay: the
// intersector of the streaming path tracer (kernel #7).
template <class Load>
struct RecordStream {
  const float* spheres;
  int n_spheres;
  const float* mats;
  const float4* rec;
  const int* off;
  int n_blocks;
  const float* cpay;

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d) const {
    float best_t = kInf;
    const int sphere = nearest_sphere(spheres, n_spheres, o, d, best_t);
    LaneHits<1> h{{lane_ray(o, d)}, {best_t}, {-1}};
    stream_records(rec, off, n_blocks, h, Load{});
    TriHit th{h.t[0], {0.0f, 0.0f, 0.0f}, -1.0f, h.slot[0]};
    if (th.slot >= 0) lane_payload(cpay, th.slot, th);
    return resolve_hit<kSphereFields, kMatFields>(spheres, sphere, mats, th,
                                                  o, d);
  }
};

}  // namespace spira
