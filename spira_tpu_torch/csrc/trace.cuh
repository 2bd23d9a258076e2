// The shared device path tracer: `trace_sample` traces one sample of a
// pixel, `trace_pixel` a pixel's samples in order (one thread per pixel, as
// kernel #1 runs; the mesh kernels split a pixel's samples over threads,
// mesh_render.cuh).
//
// Both are templated on their intersector, the counterpart of
// `trace_tile(intersect_fn=...)` in spira_tpu_torch/kernels/megakernel.py:
// the sphere/triangle brute force below and the packed-BVH walk of bvh.cuh
// share one copy of the raygen, shading, scatter and Russian-roulette code.
//
// The arithmetic follows the plain PyTorch tracer operation by operation,
// in the same order, so that a build without FMA contraction (-fmad=false)
// and with precise sqrtf/logf/sinf/cosf reproduces it to the last bit
// wherever the library functions agree.  Where the plain version computes
// both sides of a select, this code computes only the side it takes; the
// values are the same.
#pragma once

#include <cstdint>

#include "pcg.cuh"

namespace spira {

constexpr float kInf = 1e20f;
constexpr float kTMin = 1e-3f;
constexpr float kScatterEps = 1e-4f;
constexpr int kRRStart = 3;
constexpr float kRRCap = 0.95f;
constexpr float kCutoff = 0.01f;
// Per-bounce PCG stream ids (stream 0 = ray generation).
constexpr uint32_t kStreams = 3;
constexpr uint32_t kSLobe = 1;
constexpr uint32_t kSFuzz = 2;
constexpr uint32_t kSGlass = 3;
// Table layouts of pack_scene / pack_triangles / pack_camera.
constexpr int kSphereFields = 16;  // cx cy cz r | albedo3 emission3 metal rough ior trans
constexpr int kTriFields = 24;     // v0 e1 e2 n | albedo3 emission3 metal rough ior trans
constexpr int kCamFields = 20;     // origin llc horizontal vertical u v lens_radius pad
// Offsets of the 10 material fields inside a record.
constexpr int kSphereMat = 4;
constexpr int kTriMat = 12;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// x / |x| as x * (1 / sqrt(|x|^2 + 1e-20)): the correctly rounded 1/sqrt,
// not rsqrtf, to match the plain version.
__device__ __forceinline__ Vec3 norm3(float x, float y, float z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z + 1e-20f);
  return {x * inv, y * inv, z * inv};
}

// Nearest hit: point, unit geometric normal, and the hit's material record
// (RGB: albedo3 emission3 metallic roughness ior transmission; spectral:
// spectral.cuh).
struct SurfaceHit {
  bool hit;
  Vec3 p;
  Vec3 n;
  const float* mat;
};

// Nearest sphere of the (S, kStride) table closer than best_t: lowers
// best_t and returns the sphere's index, or returns -1.  A record starts
// cx cy cz r; the RGB tables have stride 16, the spectral ones 33.
template <int kStride = kSphereFields>
__device__ __forceinline__ int nearest_sphere(const float* spheres,
                                              int n_spheres, Vec3 o, Vec3 d,
                                              float& best_t) {
  int best = -1;
  for (int k = 0; k < n_spheres; ++k) {
    const float* s = spheres + k * kStride;
    const float ocx = o.x - s[0];
    const float ocy = o.y - s[1];
    const float ocz = o.z - s[2];
    const float r = s[3];
    const float half_b = ocx * d.x + ocy * d.y + ocz * d.z;
    const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
    const float disc = half_b * half_b - c;
    if (disc > 0.0f) {
      const float sqrtd = sqrtf(disc);
      const float root0 = -half_b - sqrtd;
      const float root1 = -half_b + sqrtd;
      const float root = root0 > kTMin ? root0 : root1;
      if (root > kTMin && root < best_t) {
        best_t = root;
        best = k;
      }
    }
  }
  return best;
}

// The hit on sphere record `s` at distance t: point, unit normal, and the
// material record at offset 4 (in the RGB and the spectral layouts).
__device__ __forceinline__ SurfaceHit sphere_surface(const float* s, Vec3 o,
                                                     Vec3 d, float t) {
  SurfaceHit h;
  h.hit = true;
  h.p = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  const float inv_r = 1.0f / s[3];
  h.n = norm3((h.p.x - s[0]) * inv_r, (h.p.y - s[1]) * inv_r,
              (h.p.z - s[2]) * inv_r);
  h.mat = s + kSphereMat;
  return h;
}

// Nearest triangle of the (T, kStride) table closer than best_t
// (Möller–Trumbore): lowers best_t and returns the triangle's index, or
// returns -1.  A record starts v0 e1 e2 (then the unit normal at offset 9).
template <int kStride = kTriFields>
__device__ __forceinline__ int nearest_tri(const float* tris, int n_tris,
                                           Vec3 o, Vec3 d, float& best_t) {
  int best = -1;
  for (int k = 0; k < n_tris; ++k) {
    const float* t = tris + k * kStride;
    const float e1x = t[3], e1y = t[4], e1z = t[5];
    const float e2x = t[6], e2y = t[7], e2z = t[8];
    const float pvx = d.y * e2z - d.z * e2y;
    const float pvy = d.z * e2x - d.x * e2z;
    const float pvz = d.x * e2y - d.y * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    if (!(fabsf(det) > 1e-9f)) continue;
    const float inv_det = 1.0f / det;
    const float tvx = o.x - t[0];
    const float tvy = o.y - t[1];
    const float tvz = o.z - t[2];
    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float vv = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
    const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
        tt < best_t) {
      best_t = tt;
      best = k;
    }
  }
  return best;
}

// The hit on triangle record `t` at distance t_hit: point, the record's
// unit normal, and the material record at offset 12.
__device__ __forceinline__ SurfaceHit tri_surface(const float* t, Vec3 o,
                                                  Vec3 d, float t_hit) {
  SurfaceHit h;
  h.hit = true;
  h.p = {o.x + t_hit * d.x, o.y + t_hit * d.y, o.z + t_hit * d.z};
  h.n = {t[9], t[10], t[11]};
  h.mat = t + kTriMat;
  return h;
}

// Brute force over every sphere, then every triangle, of tables that the
// kernel holds in shared memory.  Record strides: spheres kSph, triangles
// kTri (v0 e1 e2 n, then the material record at offset 12).
template <int kSph, int kTri>
struct BruteIntersectT {
  const float* spheres;
  int n_spheres;
  const float* tris;
  int n_tris;

  __device__ SurfaceHit operator()(Vec3 o, Vec3 d) const {
    float best_t = kInf;
    const int best = nearest_sphere<kSph>(spheres, n_spheres, o, d, best_t);
    const int best_tri = nearest_tri<kTri>(tris, n_tris, o, d, best_t);
    if (!(best_t < kInf)) {
      SurfaceHit h;
      h.hit = false;
      return h;
    }
    if (best_tri < 0) {
      return sphere_surface(spheres + best * kSph, o, d, best_t);
    }
    return tri_surface(tris + best_tri * kTri, o, d, best_t);
  }
};

// The RGB tables of pack_scene / pack_triangles.
using BruteIntersect = BruteIntersectT<kSphereFields, kTriFields>;

// Sample s's camera ray (pinhole, or thin lens from the raygen draw's
// spare outputs); `base` is the sample's first PCG stream id.
__device__ __forceinline__ void camera_ray(const float* cam, bool has_lens,
                                           uint32_t pixel, uint32_t s32,
                                           uint32_t base, uint32_t seed,
                                           float row_f, float col_f, float du,
                                           float dv, Vec3& o, Vec3& d) {
  const Uniform4 rg = uniform4(pixel, s32, base, seed);
  const float u = (col_f + rg.x) / du;
  const float v = (row_f + rg.y) / dv;
  const float dx = cam[3] + u * cam[6] + v * cam[9] - cam[0];
  const float dy = cam[4] + u * cam[7] + v * cam[10] - cam[1];
  const float dz = cam[5] + u * cam[8] + v * cam[11] - cam[2];
  if (has_lens) {
    const float rad = cam[18] * sqrtf(rg.z);
    const float phi = kTwoPi * rg.w;
    const float cp = cosf(phi);
    const float sp = sinf(phi);
    const float offx = rad * (cp * cam[12] + sp * cam[15]);
    const float offy = rad * (cp * cam[13] + sp * cam[16]);
    const float offz = rad * (cp * cam[14] + sp * cam[17]);
    d = norm3(dx - offx, dy - offy, dz - offz);
    o = {cam[0] + offx, cam[1] + offy, cam[2] + offz};
  } else {
    d = norm3(dx, dy, dz);
    o = {cam[0], cam[1], cam[2]};
  }
}

// The scattered direction at a hit: the specular lobe (mirror plus
// roughness fuzz, and the dielectric sub-lobe) where lobe.x < metallic,
// else the cosine-weighted diffuse lobe.  n faces the incoming ray d;
// m is the hit's 10-field material record; `bounce` is the bounce's first
// PCG stream id.
__device__ __forceinline__ Vec3 scatter_dir(Vec3 d, Vec3 n, bool entering,
                                            const float* m,
                                            const Uniform4& lobe,
                                            uint32_t pixel, uint32_t s32,
                                            uint32_t bounce, uint32_t seed) {
  const float d_dot_n = dot3(d, n);
  Vec3 nd;
  if (lobe.x < m[6]) {
    // ---- specular lobe: mirror + roughness fuzz
    const Uniform4 f = uniform4(pixel, s32, bounce + kSFuzz, seed);
    float g1, g2, g3, g4;
    box_muller(f.x, f.y, g1, g2);
    box_muller(f.z, f.w, g3, g4);
    const float rx = d.x - 2.0f * d_dot_n * n.x;
    const float ry = d.y - 2.0f * d_dot_n * n.y;
    const float rz = d.z - 2.0f * d_dot_n * n.z;
    const Vec3 fz = norm3(g1, g2, g3);
    const float rough = m[7];
    nd = norm3(rx + rough * fz.x, ry + rough * fz.y, rz + rough * fz.z);
    // ---- dielectric sub-lobe (Schlick Fresnel + Snell)
    const Uniform4 gl = uniform4(pixel, s32, bounce + kSGlass, seed);
    if (gl.x < m[9]) {
      const float ior = m[8];
      const float eta = entering ? 1.0f / ior : ior;
      const float cos_i = fminf(fmaxf(-d_dot_n, 0.0f), 1.0f);
      const float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
      const bool tir = sin2_t > 1.0f;
      const float q = (1.0f - ior) / (1.0f + ior);
      const float r0 = q * q;
      const float one_m = 1.0f - cos_i;
      const float schlick =
          r0 + (1.0f - r0) * one_m * one_m * one_m * one_m * one_m;
      if (!(tir || gl.y < schlick)) {
        const float cos_t = sqrtf(1.0f - sin2_t);
        const float k = eta * cos_i - cos_t;
        nd = norm3(eta * d.x + k * n.x, eta * d.y + k * n.y,
                   eta * d.z + k * n.z);
      }
    }
  } else {
    // ---- diffuse lobe: cosine hemisphere via disk projection
    const float phi = kTwoPi * lobe.z;
    const float sq = sqrtf(lobe.w);
    const float ddx = cosf(phi) * sq;
    const float ddy = sinf(phi) * sq;
    const float ddz = sqrtf(fmaxf(0.0f, 1.0f - lobe.w));
    const bool pick_y = fabsf(n.x) > 0.1f;
    const float ax = pick_y ? 0.0f : 1.0f;
    const float ay = pick_y ? 1.0f : 0.0f;
    const Vec3 bu = norm3(ay * n.z, -ax * n.z, ax * n.y - ay * n.x);
    const float bvx = n.y * bu.z - n.z * bu.y;
    const float bvy = n.z * bu.x - n.x * bu.z;
    const float bvz = n.x * bu.y - n.y * bu.x;
    nd = norm3(ddx * bu.x + ddy * bvx + ddz * n.x,
               ddx * bu.y + ddy * bvy + ddz * n.y,
               ddx * bu.z + ddy * bvz + ddz * n.z);
  }
  return nd;
}

// Whether an intersector takes the bounce index: one with a
// `begin_bounce(int)` method has it called before each bounce's
// intersection, as JAX's trace_tile passes `bounce` to an intersect_fn
// that sets `wants_bounce` (spira_tpu/kernels/megakernel.py:322-326).
// Every other intersector compiles as before.
template <class T, class = void>
struct WantsBounce {
  static constexpr bool value = false;
};
template <class T>
struct WantsBounce<T, decltype(void(&T::begin_bounce))> {
  static constexpr bool value = true;
};

// A sample's path in flight: what trace_sample carries from one bounce to
// the next.
struct Path {
  Vec3 o, d;           // the ray of the next bounce
  float tr, tg, tb;    // throughput
  float lr, lg, lb;    // radiance so far
  uint32_t s32, base;  // the sample, its first PCG stream id
};

// Sample s's path at bounce 0: its camera ray, unit throughput, no
// radiance.
__device__ __forceinline__ Path start_path(const float* cam, bool has_lens,
                                           uint32_t pixel, float row_f,
                                           float col_f, uint32_t seed, int s,
                                           int max_depth, float du,
                                           float dv) {
  Path p;
  const uint32_t per_sample = static_cast<uint32_t>(max_depth) * kStreams + 1u;
  p.s32 = static_cast<uint32_t>(s);
  p.base = p.s32 * per_sample;
  camera_ray(cam, has_lens, pixel, p.s32, p.base, seed, row_f, col_f, du, dv,
             p.o, p.d);
  p.tr = p.tg = p.tb = 1.0f;
  p.lr = p.lg = p.lb = 0.0f;
  return p;
}

// Bounce b of the path, whose nearest hit is h: on a miss the sky ends it;
// on a hit, emission, the scattered direction, throughput and Russian
// roulette, then the next bounce's ray.  Returns whether the path goes on
// (its caller ends it at max_depth).
__device__ __forceinline__ bool shade_path(Path& p, const SurfaceHit& h,
                                           int b, uint32_t pixel,
                                           uint32_t seed) {
  if (!h.hit) {
    // ---- miss: sky gradient
    const float t_sky = 0.5f * (p.d.y + 1.0f);
    p.lr += p.tr * (1.0f - t_sky + 0.5f * t_sky);
    p.lg += p.tg * (1.0f - t_sky + 0.7f * t_sky);
    p.lb += p.tb * (1.0f - t_sky + 1.0f * t_sky);
    return false;
  }
  const float* m = h.mat;
  // ---- emission
  p.lr += p.tr * m[3];
  p.lg += p.tg * m[4];
  p.lb += p.tb * m[5];

  Vec3 n = h.n;
  const bool entering = dot3(p.d, n) < 0.0f;
  if (!entering) n = {-n.x, -n.y, -n.z};

  const uint32_t bounce = p.base + static_cast<uint32_t>(b) * kStreams;
  const Uniform4 lobe = uniform4(pixel, p.s32, bounce + kSLobe, seed);
  const Vec3 nd = scatter_dir(p.d, n, entering, m, lobe, pixel, p.s32,
                              bounce, seed);

  // ---- throughput *= albedo, then Russian roulette
  float ntr = p.tr * m[0];
  float ntg = p.tg * m[1];
  float ntb = p.tb * m[2];
  if (b > kRRStart) {
    const float p_cont =
        fminf(fmaxf(fmaxf(ntr, fmaxf(ntg, ntb)), 1e-6f), kRRCap);
    if (lobe.y > p_cont) return false;
    const float inv_p = 1.0f / p_cont;
    ntr = ntr * inv_p;
    ntg = ntg * inv_p;
    ntb = ntb * inv_p;
    if (!(fmaxf(ntr, fmaxf(ntg, ntb)) >= kCutoff)) return false;
  }

  // offset along the hemisphere the new direction leaves through
  const float osgn = dot3(nd, n) >= 0.0f ? 1.0f : -1.0f;
  p.o = {h.p.x + kScatterEps * osgn * n.x, h.p.y + kScatterEps * osgn * n.y,
         h.p.z + kScatterEps * osgn * n.z};
  p.d = nd;
  p.tr = ntr;
  p.tg = ntg;
  p.tb = ntb;
  return true;
}

// Trace sample s of one pixel; returns its radiance.  pixel: the PCG
// counter row * width + col (row counted from the image bottom, unpadded
// width); cam: the 20-float camera record.  A sample's PCG counters are
// functions of (pixel, s) alone, so any thread can trace any sample.
template <class Intersect>
__device__ __forceinline__ Vec3 trace_sample(const Intersect& intersect,
                                             const float* cam, bool has_lens,
                                             uint32_t pixel, float row_f,
                                             float col_f, uint32_t seed,
                                             int s, int max_depth, float du,
                                             float dv) {
  Path p = start_path(cam, has_lens, pixel, row_f, col_f, seed, s, max_depth,
                      du, dv);
  for (int b = 0; b < max_depth; ++b) {
    if constexpr (WantsBounce<Intersect>::value) intersect.begin_bounce(b);
    if (!shade_path(p, intersect(p.o, p.d), b, pixel, seed)) break;
  }
  return {p.lr, p.lg, p.lb};
}

// Trace `spp` samples of one pixel; returns the summed radiance, added in
// sample order (the order every kernel that splits a pixel's samples
// over threads keeps, so the sum is the same to the bit).
template <class Intersect>
__device__ Vec3 trace_pixel(const Intersect& intersect, const float* cam,
                            bool has_lens, uint32_t pixel, float row_f,
                            float col_f, uint32_t seed, int spp, int max_depth,
                            float du, float dv) {
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const Vec3 l = trace_sample(intersect, cam, has_lens, pixel, row_f, col_f,
                                seed, s, max_depth, du, dv);
    acc_r = acc_r + l.x;
    acc_g = acc_g + l.y;
    acc_b = acc_b + l.z;
  }
  return {acc_r, acc_g, acc_b};
}

}  // namespace spira
