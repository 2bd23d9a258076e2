// Superleaf block visit: one ray against the 128 triangles of a Plücker
// coefficient block (spira_tpu_torch/accel/mxu.py), the leaf test of the
// superleaf engines.
//
// Replaces the block visit of the JAX package's matrix-unit engines:
// spira_tpu/kernels/mxu_megakernel.py:_stream_blocks (the streaming kernel
// #7 and its nearest-hit query #8) and spira_tpu/kernels/bvh_megakernel.py:
// _make_mxu_leaf_visit (#2b, the leaf of the packet walk with
// mxu_leaf=True).  There a block is contracted against a whole ray tile on
// the TPU's matrix unit, (384, 8) x (8, 1024), and the winner of each column
// is picked by a lane argmin and a one-hot payload product.  Here one thread
// holds one ray and tests the block's lanes in order:
//
//   for lane j = 0..127:
//     det, u_num, v_num = columns j, 128 + j, 256 + j of coeff_uv rows 0-5
//                         against F_uv = [m, d] (m = o x d), left to right
//     t_num             = column j of coeff_t rows 0-2 against o, + row 6
//     idet = 1 / det; u, v, t = u_num, v_num, t_num * idet
//     hit: u >= 0, v >= 0, u + v <= 1, t > t_min, t < best, |det| > 1e-12
//
// The rows that meet a zero feature (coeff_uv rows 6-7 against F_uv's
// zeros, coeff_t rows 3-5 and 7 against F_o1's) are left out: they add a
// signed zero.  The plain version (kernels/bvh_megakernel.py:lane_hits)
// sums the same terms in the same order, and with -fmad=false and IEEE
// division the two agree to the bit.  Padding lanes are all zero: det == 0
// gives idet = inf and u, v, t inf or NaN, which fail every comparison.
// A strict `t < h.t` in lane order keeps the lowest lane of equal hits,
// the JAX kernel's argmin rule; across blocks the same strict `<` holds.
//
// What bounds it: per lane 18 loads of coeff_uv and 4 of coeff_t (read
// through __ldg from L2; in the streaming kernel every thread of a warp
// reads the same address, so each load is one broadcast transaction) and
// about 40 float operations.  Nothing is staged in shared memory yet, and
// no tensor core is used: a later PR's work (a block per CTA in shared
// memory, or an fp32-exact 3xTF32 mma of the contraction).
#pragma once

#include <cstdint>

#include "bvh.cuh"
#include "trace.cuh"

namespace spira {

constexpr int kSuperleaf = 128;  // SUPERLEAF: lanes (triangles) of a block
constexpr int kBlockRows = 8;    // BLOCK_ROWS: rows of a block in each table
constexpr int kUVCols = 3 * kSuperleaf;  // coeff_uv: [det | u_num | v_num]

// Test the 128 lanes of `block` against the ray (o, d), lowering h to the
// nearest hit below h.t.  cuv (B*8, 384), ct and cpay (B*8, 128): the
// coefficient tables as packed, row-major float32.
__device__ __forceinline__ void visit_block(const float* __restrict__ cuv,
                                            const float* __restrict__ ct,
                                            const float* __restrict__ cpay,
                                            int block, Vec3 o, Vec3 d,
                                            TriHit& h) {
  const float mx = o.y * d.z - o.z * d.y;
  const float my = o.z * d.x - o.x * d.z;
  const float mz = o.x * d.y - o.y * d.x;
  const int64_t base = static_cast<int64_t>(block) * kBlockRows;
  const float* uv = cuv + base * kUVCols;
  const float* tc = ct + base * kSuperleaf;
  for (int j = 0; j < kSuperleaf; ++j) {
    float q[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* c = uv + s * kSuperleaf + j;
      float acc = __ldg(c) * mx;
      acc = acc + __ldg(c + kUVCols) * my;
      acc = acc + __ldg(c + 2 * kUVCols) * mz;
      acc = acc + __ldg(c + 3 * kUVCols) * d.x;
      acc = acc + __ldg(c + 4 * kUVCols) * d.y;
      acc = acc + __ldg(c + 5 * kUVCols) * d.z;
      q[s] = acc;
    }
    const float* c = tc + j;
    float tn = __ldg(c) * o.x + __ldg(c + kSuperleaf) * o.y;
    tn = tn + __ldg(c + 2 * kSuperleaf) * o.z;
    tn = tn + __ldg(c + 6 * kSuperleaf);
    const float det = q[0];
    const float idet = 1.0f / det;
    const float uu = q[1] * idet;
    const float vv = q[2] * idet;
    const float tt = tn * idet;
    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
        tt < h.t && fabsf(det) > 1e-12f) {
      const float* p = cpay + base * kSuperleaf + j;
      h.t = tt;
      h.n = {__ldg(p), __ldg(p + kSuperleaf), __ldg(p + 2 * kSuperleaf)};
      h.mid = __ldg(p + 3 * kSuperleaf);
      h.slot = block * kSuperleaf + j;
    }
  }
}

// Every block in order: the streaming engine's intersect (kernels #7, #8).
__device__ __forceinline__ void stream_blocks(const float* __restrict__ cuv,
                                              const float* __restrict__ ct,
                                              const float* __restrict__ cpay,
                                              int n_blocks, Vec3 o, Vec3 d,
                                              TriHit& h) {
  for (int b = 0; b < n_blocks; ++b) visit_block(cuv, ct, cpay, b, o, d, h);
}

// Superleaf leaves of a pair tree (accel/mxu.py:SuperleafBVH): a leaf
// child's ptr is a block index; its count is not needed, the visit tests
// all 128 lanes.
struct BlockLeaves {
  const float* cuv;
  const float* ct;
  const float* cpay;

  __device__ void operator()(int ptr, int /*cnt*/, Vec3 o, Vec3 d,
                             TriHit& h) const {
    visit_block(cuv, ct, cpay, ptr, o, d, h);
  }
};

// Spheres first (their nearest hit seeds best_t), then every block: the
// intersector of the streaming path tracer (kernel #7).
struct StreamIntersect {
  const float* spheres;
  int n_spheres;
  const float* mats;
  const float* cuv;
  const float* ct;
  const float* cpay;
  int n_blocks;

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d) const {
    float best_t = kInf;
    const int sphere = nearest_sphere(spheres, n_spheres, o, d, best_t);
    TriHit th{best_t, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
    stream_blocks(cuv, ct, cpay, n_blocks, o, d, th);
    return resolve_hit<kSphereFields, kMatFields>(spheres, sphere, mats, th,
                                                  o, d);
  }
};

}  // namespace spira
