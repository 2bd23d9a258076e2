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

// Superleaf leaves of a pair tree (accel/mxu.py:SuperleafBVH), the leaves
// of #2b: a leaf child's ptr is a block index (its count is not needed),
// whose real lanes are read through the read-only path; the payload is
// read once a visit, for its winner.
struct RecordLeaves {
  const float4* rec;
  const int* off;
  const float* cpay;

  __device__ void operator()(int ptr, int /*cnt*/, Vec3 o, Vec3 d,
                             TriHit& h) const {
    LaneHits<1> lh{{lane_ray(o, d)}, {h.t}, {-1}};
    const int begin = __ldg(off + ptr);
    visit_lanes<1>(rec + begin * kRecVecs, __ldg(off + ptr + 1) - begin, ptr,
                   lh, GlobalLoad{});
    if (lh.slot[0] >= 0) {
      h.t = lh.t[0];
      h.slot = lh.slot[0];
      lane_payload(cpay, h.slot, h);
    }
  }
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
