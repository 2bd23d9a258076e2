// Packed-BVH nearest hit: a per-thread depth-first walk over the pair
// records of spira_tpu_torch/accel/pairs.py, templated on its leaf visitor
// (the leaf rows here, `RowLeaves`; the superleaf blocks of
// superleaf.cuh, `BlockLeaves`), and the `TreeIntersect` intersector that
// plugs it into trace.cuh:trace_pixel (`PackedIntersect` over row leaves).
//
// Replaces the packet traversal of spira_tpu/kernels/bvh_megakernel.py
// (make_packet_intersect and run_packet_traversal).  There a whole
// (tile_h, 128) packet walks the tree behind one scalar stack; here each
// thread walks it for its own ray with a private stack.  Traversal order
// cannot change the nearest hit, only which of two equal hits wins.
//
// The walk, step for step as the plain version
// (spira_tpu_torch/kernels/bvh_megakernel.py:packed_walk): pop a record;
// slab-test both children against best_t at the pop, the near side clamped
// at 0; visit hit leaves at once, nearer child first; push hit internal
// children far first.  Children are ordered by their clamped entry
// distance, slot 0 winning a tie.  Leaf triangles are tested in slot order
// with a strict `t < best_t`.
//
// Tables are read from device memory through the read-only path (__ldg),
// 16 bytes at a time: a pair record is 4 float4, a leaf triangle 4 float4.
// The bunny's 5.5 MB of tables stay resident in the 50 MB L2.
#pragma once

#include <cstdint>

#include "trace.cuh"

namespace spira {

constexpr int kTrisPerRow = 8;    // TRIS_PER_ROW
constexpr int kMatFields = 16;    // pack_materials record
// TRAVERSAL_STACK in accel/pairs.py.  A depth-first walk that pushes both
// children of a record holds at most one pending sibling per level, so a
// tree of at most kStackSize pair records on its longest chain (checked by
// the wrappers) never overflows it.
constexpr int kStackSize = 128;
constexpr int kFormMT = 0;  // [v0 e1 e2 n mat pad3]
constexpr int kFormBW = 1;  // [n dn A a3 B b3 mat pad3]

// Nearest triangle hit so far: t is the exclusive bound of the search.
struct TriHit {
  float t;
  Vec3 n;
  float mid;  // material id, -1: no triangle hit
  int slot;   // tri-row slot (row * 8 + j) of the winner, -1: none
};

struct Child {
  bool hit;
  float tn;  // entry distance, clamped at 0
  int ptr;
  int cnt;  // < 0 empty slot, 0 internal (ptr: pair row), > 0 leaf
};

// Half of a pair record: a = (min.xyz, max.x), b = (max.yz, ptr, count).
__device__ __forceinline__ Child slab_child(float4 a, float4 b, Vec3 o,
                                            Vec3 inv, float best) {
  float t0 = (a.x - o.x) * inv.x;
  float t1 = (a.w - o.x) * inv.x;
  float tn = fminf(t0, t1);
  float tf = fmaxf(t0, t1);
  t0 = (a.y - o.y) * inv.y;
  t1 = (b.x - o.y) * inv.y;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (a.z - o.z) * inv.z;
  t1 = (b.y - o.z) * inv.z;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  Child c;
  c.tn = fmaxf(tn, 0.0f);
  c.hit = c.tn <= fminf(tf, best) && b.w > -0.5f;
  c.ptr = static_cast<int>(b.z);
  c.cnt = static_cast<int>(b.w);
  return c;
}

// Test the `cnt` triangles of the leaf at row `ptr` (rows of 8 slots; a
// leaf of more than 8 spans consecutive rows).
template <int kForm>
__device__ __forceinline__ void visit_leaf(const float4* __restrict__ slots,
                                           int ptr, int cnt, Vec3 o, Vec3 d,
                                           TriHit& h) {
  const int base = ptr * kTrisPerRow;
  for (int j = 0; j < cnt; ++j) {
    const float4* f = slots + static_cast<int64_t>(base + j) * 4;
    const float4 f0 = __ldg(f);
    const float4 f1 = __ldg(f + 1);
    const float4 f2 = __ldg(f + 2);
    float tt, uu, vv;
    bool ok;
    Vec3 n;
    if (kForm == kFormBW) {
      // Baldwin–Weber: plane hit, then two affine barycentric maps.  The
      // JAX kernel refines an approximate reciprocal with one Newton step;
      // here r0 is the IEEE 1/den and the same expression follows, so the
      // kernel and the plain version agree to the bit.  den == 0 gives
      // NaN, which fails every comparison below.
      const float den = f0.x * d.x + f0.y * d.y + f0.z * d.z;
      const float num = f0.w - (f0.x * o.x + f0.y * o.y + f0.z * o.z);
      const float r0 = 1.0f / den;
      tt = num * (r0 * (2.0f - den * r0));
      const float px = o.x + tt * d.x;
      const float py = o.y + tt * d.y;
      const float pz = o.z + tt * d.z;
      uu = f1.x * px + f1.y * py + f1.z * pz + f1.w;
      vv = f2.x * px + f2.y * py + f2.z * pz + f2.w;
      ok = true;
      n = {f0.x, f0.y, f0.z};
    } else {
      // Möller–Trumbore; f0 = v0.xyz e1.x, f1 = e1.yz e2.xy, f2 = e2.z n
      const float e1x = f0.w, e1y = f1.x, e1z = f1.y;
      const float e2x = f1.z, e2y = f1.w, e2z = f2.x;
      const float pvx = d.y * e2z - d.z * e2y;
      const float pvy = d.z * e2x - d.x * e2z;
      const float pvz = d.x * e2y - d.y * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = 1.0f / det;
      const float tvx = o.x - f0.x;
      const float tvy = o.y - f0.y;
      const float tvz = o.z - f0.z;
      uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      vv = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
      tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      ok = fabsf(det) > 1e-9f;
      n = {f2.y, f2.z, f2.w};
    }
    if (ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
        tt < h.t) {
      h.t = tt;
      h.n = n;
      h.mid = __ldg(f + 3).x;
      h.slot = base + j;
    }
  }
}

// Leaves of the pair tables: rows of 8 triangles in form kForm.
template <int kForm>
struct RowLeaves {
  const float4* slots;

  __device__ void operator()(int ptr, int cnt, Vec3 o, Vec3 d,
                             TriHit& h) const {
    visit_leaf<kForm>(slots, ptr, cnt, o, d, h);
  }
};

// What a walk counts.  NoCount: nothing, with empty inline methods, so
// every kernel that walks without counting compiles as it did before the
// counts existed.  WalkCounts: one thread's work totals, the counting build
// of kernel #2 (spira_tpu/kernels/bvh_megakernel.py:_kernel with
// counters=True), counted per ray where JAX counts per TPU packet:
//   pops                records popped
//   pushes              internal children pushed
//   traversals          walks entered (one per live path segment)
//   leaf_visits         leaf children visited
//   leaf_tris           leaf triangles tested (new: the per-thread leaf
//                       loop's cost)
//   leaf_visits_primary leaf visits at bounce 0
//   hits                segments whose nearest hit is a surface (counted by
//                       CountingIntersect, for the bound's hit/miss terms)
// JAX's pop_batches, leaf_blocks_run/total and leaf_retests_culled count
// the K-pop packet batch, leaf_gate and defer_leaves, TPU knobs that are
// not ported; they have no counterpart.  Every popped record is the root
// or was pushed, so pops == traversals + pushes.
struct NoCount {
  __device__ __forceinline__ void walk() {}
  __device__ __forceinline__ void pop() {}
  __device__ __forceinline__ void push() {}
  __device__ __forceinline__ void leaf(int) {}
};

constexpr int kNumCounts = 7;

struct WalkCounts {
  uint32_t pops = 0, pushes = 0, traversals = 0, leaf_visits = 0,
           leaf_tris = 0, leaf_visits_primary = 0, hits = 0;
  int bounce = 0;  // the bounce of the walk in progress

  __device__ __forceinline__ void walk() { ++traversals; }
  __device__ __forceinline__ void pop() { ++pops; }
  __device__ __forceinline__ void push() { ++pushes; }
  __device__ __forceinline__ void leaf(int cnt) {
    ++leaf_visits;
    leaf_tris += static_cast<uint32_t>(cnt);
    if (bounce == 0) ++leaf_visits_primary;
  }
};

// The nearest triangle hit below h.t over the whole tree;
// `leaves(ptr, cnt, o, d, h)` tests a leaf child; `count` counts the walk
// (NoCount or WalkCounts).
template <class Leaves, class Count>
__device__ void walk_packed(const float4* __restrict__ pairs,
                            const Leaves& leaves, int root, Vec3 o, Vec3 d,
                            TriHit& h, Count& count) {
  const Vec3 inv = {fabsf(d.x) > 1e-12f ? 1.0f / d.x : 1e12f,
                    fabsf(d.y) > 1e-12f ? 1.0f / d.y : 1e12f,
                    fabsf(d.z) > 1e-12f ? 1.0f / d.z : 1e12f};
  int stack[kStackSize];
  int sp = 0;
  stack[sp++] = root;
  count.walk();
  while (sp > 0) {
    const float4* r = pairs + static_cast<int64_t>(stack[--sp]) * 4;
    count.pop();
    const float best = h.t;
    const Child c0 = slab_child(__ldg(r), __ldg(r + 1), o, inv, best);
    const Child c1 = slab_child(__ldg(r + 2), __ldg(r + 3), o, inv, best);
    const bool near0 = c0.tn <= c1.tn;
    const Child cn = near0 ? c0 : c1;
    const Child cf = near0 ? c1 : c0;
    if (cn.hit && cn.cnt > 0) {
      count.leaf(cn.cnt);
      leaves(cn.ptr, cn.cnt, o, d, h);
    }
    if (cf.hit && cf.cnt > 0) {
      count.leaf(cf.cnt);
      leaves(cf.ptr, cf.cnt, o, d, h);
    }
    if (cf.hit && cf.cnt == 0) {
      count.push();
      stack[sp++] = cf.ptr;
    }
    if (cn.hit && cn.cnt == 0) {
      count.push();
      stack[sp++] = cn.ptr;
    }
  }
}

template <class Leaves>
__device__ __forceinline__ void walk_packed(const float4* __restrict__ pairs,
                                            const Leaves& leaves, int root,
                                            Vec3 o, Vec3 d, TriHit& h) {
  NoCount none;
  walk_packed(pairs, leaves, root, o, d, h, none);
}

// The surface of a nearest hit: the triangle hit th, or, where no
// triangle beat it (th.mid < 0), the sphere `sphere` that seeded th.t.
// Record strides: spheres kSph, materials kMat.
template <int kSph, int kMat>
__device__ __forceinline__ SurfaceHit resolve_hit(const float* spheres,
                                                  int sphere,
                                                  const float* mats,
                                                  const TriHit& th, Vec3 o,
                                                  Vec3 d) {
  SurfaceHit h;
  h.hit = th.t < kInf;
  if (!h.hit) return h;
  if (th.mid < 0.0f) {
    return sphere_surface(spheres + sphere * kSph, o, d, th.t);
  }
  h.p = {o.x + th.t * d.x, o.y + th.t * d.y, o.z + th.t * d.z};
  h.n = th.n;
  h.mat = mats + static_cast<int>(th.mid) * kMat;
  return h;
}

// Spheres first (their nearest hit seeds best_t), then the pair tree with
// leaves `Leaves`.  Sphere and material tables live in shared memory; the
// tree in device memory.  Record strides: spheres kSph, materials kMat
// (the RGB tables by default; spectral.cuh passes its own).
template <class Leaves, int kSph = kSphereFields, int kMat = kMatFields>
struct TreeIntersect {
  const float* spheres;
  int n_spheres;
  const float* mats;
  const float4* pairs;
  Leaves leaves;
  int root;

  template <class Count>
  __device__ SurfaceHit intersect(Vec3 o, Vec3 d, Count& count) const {
    float best_t = kInf;
    const int sphere = nearest_sphere<kSph>(spheres, n_spheres, o, d, best_t);
    TriHit th{best_t, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
    walk_packed(pairs, leaves, root, o, d, th, count);
    return resolve_hit<kSph, kMat>(spheres, sphere, mats, th, o, d);
  }

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d) const {
    NoCount none;
    return intersect(o, d, none);
  }
};

// TreeIntersect counting its walks into *counts, and the segments that hit
// a surface; takes the bounce index (trace.cuh:WantsBounce) for the
// primary-bounce leaf visits.
template <class Leaves>
struct CountingIntersect {
  TreeIntersect<Leaves> tree;
  WalkCounts* counts;

  __device__ void begin_bounce(int b) const { counts->bounce = b; }

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d) const {
    const SurfaceHit h = tree.intersect(o, d, *counts);
    if (h.hit) ++counts->hits;
    return h;
  }
};

// The packed mesh: the pair tree over leaf rows in form kForm.
template <int kForm, int kSph = kSphereFields, int kMat = kMatFields>
using PackedIntersect = TreeIntersect<RowLeaves<kForm>, kSph, kMat>;

}  // namespace spira
