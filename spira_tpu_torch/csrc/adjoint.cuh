// The reverse-mode adjoint of trace.cuh:trace_pixel over the brute-force
// sphere/triangle tables: one sample of one pixel, traced forward with a
// per-bounce tape, then swept backwards bounce by bounce.
//
// It computes what autograd through the plain tracer computes
// (spira_tpu_torch/kernels/megakernel.py:trace_tile, itself the twin of
// the JAX fused tracer that spira_tpu/kernels/grad_megakernel.py replays
// per sample): the vector-Jacobian product of one sample's radiance with a
// cotangent, into the camera record (1, 20) and the packed sphere (S, 16)
// and triangle (T, 24) tables.  Where the plain version computes both
// sides of a select and relies on double-`where` guards to zero the
// untaken side's gradient, the adjoint differentiates only the side the
// path took, which gives the same values.  Decisions (hit or miss, which
// primitive, entering, the lobe, glass, reflection and total internal
// reflection, the helper axis of the diffuse basis, Russian roulette and
// the cutoff, the side of the origin offset) carry no gradient; the
// roulette probability is a constant, as the plain version detaches it.
//
// The tape holds, per bounce, the ray (origin, direction), the throughput
// before the bounce, the hit's primitive and distance, and the roulette
// scale 1/p_cont.  Everything else the reverse sweep needs (hit point,
// normal before and after the flip, the lobe's intermediates) it
// recomputes from those with the same arithmetic as the forward; the PCG
// draws need no tape because the hash is a stateless counter.  Where the
// tape lives is the caller's choice: `sample_vjp` takes an accessor with
// `store(b, entry)` and `load(b)` (shared memory, field-major, in
// grad_megakernel.cu; an array in the host build of the tests).
//
// Every float operation is written so that the file also compiles as
// plain host C++ (no intrinsics).  Accumulation into the scene tables goes
// through the `Add` functor the caller passes, `add(p, v)` adding v at p
// (shared-memory atomics into a lane's copy of the accumulators in
// grad_megakernel.cu, a plain += on the host).
#pragma once

#include <cstdint>

#include "trace.cuh"

namespace spira {

// The deepest path the tape records; the wrapper refuses a deeper
// max_depth.
constexpr int kMaxTape = 16;
// 32-bit words a tape entry stores (TapeEntry's fields, prim as a float).
constexpr int kTapeWords = 12;

struct TapeEntry {
  Vec3 o, d;          // the ray at the bounce's start
  float tr, tg, tb;   // throughput before the bounce
  float t;            // hit distance
  float scale;        // Russian roulette's 1 / p_cont, else 1
  int prim;           // sphere k >= 0; triangle k as -(k + 2); miss -1
};

__device__ __forceinline__ Vec3 add3(Vec3 a, Vec3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ Vec3 sub3(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Vec3 scale3(float s, Vec3 a) {
  return {s * a.x, s * a.y, s * a.z};
}

__device__ __forceinline__ Vec3 cross3(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// Cotangent of x for norm3(x) = x / sqrt(|x|^2 + 1e-20) given the
// cotangent g of the result (the epsilon included).
__device__ __forceinline__ Vec3 norm3_adj(Vec3 x, Vec3 g) {
  const float inv = 1.0f / sqrtf(x.x * x.x + x.y * x.y + x.z * x.z + 1e-20f);
  const float k = dot3(g, x) * inv * inv * inv;
  return {g.x * inv - x.x * k, g.y * inv - x.y * k, g.z * inv - x.z * k};
}

template <class Add>
__device__ __forceinline__ void add3_to(const Add& add, float* p, Vec3 g) {
  add(p + 0, g.x);
  add(p + 1, g.y);
  add(p + 2, g.z);
}

// One sample of trace_pixel's bounce loop, recording the tape through the
// accessor (`tape.store(b, entry)`); returns the number of entries (the
// last is a miss, or a hit after which the path ended).  The radiance is
// not needed: the sample's contribution is linear in the cotangent.
template <class Tape>
__device__ __forceinline__ int trace_taped(
    const float* sph, int n_sph, const float* tri, int n_tri, Vec3 o, Vec3 d,
    uint32_t pixel, uint32_t s32, uint32_t base, uint32_t seed,
    int max_depth, const Tape& tape) {
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  for (int b = 0; b < max_depth; ++b) {
    TapeEntry e;
    e.o = o;
    e.d = d;
    e.tr = tr;
    e.tg = tg;
    e.tb = tb;
    e.t = 0.0f;
    e.scale = 1.0f;
    float best_t = kInf;
    const int ks = nearest_sphere(sph, n_sph, o, d, best_t);
    const int kt = nearest_tri(tri, n_tri, o, d, best_t);
    if (!(best_t < kInf)) {
      e.prim = -1;
      tape.store(b, e);
      return b + 1;
    }
    e.t = best_t;
    SurfaceHit h;
    if (kt >= 0) {
      e.prim = -(kt + 2);
      h = tri_surface(tri + kt * kTriFields, o, d, best_t);
    } else {
      e.prim = ks;
      h = sphere_surface(sph + ks * kSphereFields, o, d, best_t);
    }
    const float* m = h.mat;
    Vec3 n = h.n;
    const bool entering = dot3(d, n) < 0.0f;
    if (!entering) n = {-n.x, -n.y, -n.z};
    const uint32_t bounce = base + static_cast<uint32_t>(b) * kStreams;
    const Uniform4 lobe = uniform4(pixel, s32, bounce + kSLobe, seed);
    const Vec3 nd = scatter_dir(d, n, entering, m, lobe, pixel, s32, bounce,
                                seed);
    float ntr = tr * m[0];
    float ntg = tg * m[1];
    float ntb = tb * m[2];
    bool ends = false;
    if (b > kRRStart) {
      const float p_cont =
          fminf(fmaxf(fmaxf(ntr, fmaxf(ntg, ntb)), 1e-6f), kRRCap);
      if (lobe.y > p_cont) {
        ends = true;
      } else {
        const float inv_p = 1.0f / p_cont;
        ntr = ntr * inv_p;
        ntg = ntg * inv_p;
        ntb = ntb * inv_p;
        e.scale = inv_p;
        ends = !(fmaxf(ntr, fmaxf(ntg, ntb)) >= kCutoff);
      }
    }
    tape.store(b, e);
    if (ends) return b + 1;
    const float osgn = dot3(nd, n) >= 0.0f ? 1.0f : -1.0f;
    o = {h.p.x + kScatterEps * osgn * n.x, h.p.y + kScatterEps * osgn * n.y,
         h.p.z + kScatterEps * osgn * n.z};
    d = nd;
    tr = ntr;
    tg = ntg;
    tb = ntb;
  }
  return max_depth;
}

// Adjoint of scatter_dir: recomputes the lobe the path took and adds the
// cotangents of d, n (the flipped normal), roughness and ior for the
// cotangent gnd of the new direction; returns the new direction.
template <class Add>
__device__ __forceinline__ Vec3 scatter_adjoint(
    Vec3 d, Vec3 n, bool entering, const float* m, float* gm,
    const Uniform4& lobe, uint32_t pixel, uint32_t s32, uint32_t bounce,
    uint32_t seed, Vec3 gnd, Vec3& gd, Vec3& gn, const Add& add) {
  const float dn = dot3(d, n);
  if (lobe.x < m[6]) {
    const Uniform4 f = uniform4(pixel, s32, bounce + kSFuzz, seed);
    float g1, g2, g3, g4;
    box_muller(f.x, f.y, g1, g2);
    box_muller(f.z, f.w, g3, g4);
    const Vec3 r = {d.x - 2.0f * dn * n.x, d.y - 2.0f * dn * n.y,
                    d.z - 2.0f * dn * n.z};
    const Vec3 fz = norm3(g1, g2, g3);
    const float rough = m[7];
    const Vec3 sv = {r.x + rough * fz.x, r.y + rough * fz.y,
                     r.z + rough * fz.z};
    const Uniform4 gl = uniform4(pixel, s32, bounce + kSGlass, seed);
    if (gl.x < m[9]) {
      const float ior = m[8];
      const float eta = entering ? 1.0f / ior : ior;
      const float cos_i = fminf(fmaxf(-dn, 0.0f), 1.0f);
      const float one_c2 = 1.0f - cos_i * cos_i;
      const float m2 = fmaxf(0.0f, one_c2);
      const float sin2_t = eta * eta * m2;
      const bool tir = sin2_t > 1.0f;
      const float q = (1.0f - ior) / (1.0f + ior);
      const float r0 = q * q;
      const float one_m = 1.0f - cos_i;
      const float schlick =
          r0 + (1.0f - r0) * one_m * one_m * one_m * one_m * one_m;
      if (!(tir || gl.y < schlick)) {
        // ---- refraction: fv = eta d + (eta cos_i - cos_t) n
        const float cos_t = sqrtf(1.0f - sin2_t);
        const float k = eta * cos_i - cos_t;
        const Vec3 fv = {eta * d.x + k * n.x, eta * d.y + k * n.y,
                         eta * d.z + k * n.z};
        const Vec3 gfv = norm3_adj(fv, gnd);
        float g_eta = dot3(gfv, d);
        gd = add3(gd, scale3(eta, gfv));
        const float g_k = dot3(gfv, n);
        gn = add3(gn, scale3(k, gfv));
        g_eta += g_k * cos_i;
        float g_cos_i = g_k * eta;
        // sqrt'(0) is infinite; the plain version guards it to 0
        const float g_sin2 = cos_t > 0.0f ? -g_k * (-0.5f / cos_t) : 0.0f;
        g_eta += g_sin2 * 2.0f * eta * m2;
        if (one_c2 >= 0.0f) g_cos_i += g_sin2 * eta * eta * (-2.0f * cos_i);
        if (-dn >= 0.0f && -dn <= 1.0f) {
          const float g_dn = -g_cos_i;
          gd = add3(gd, scale3(g_dn, n));
          gn = add3(gn, scale3(g_dn, d));
        }
        add(gm + 8, entering ? -g_eta / (ior * ior) : g_eta);
        return norm3(fv.x, fv.y, fv.z);
      }
    }
    // ---- mirror + roughness fuzz: sv = d - 2 (d.n) n + rough fz
    const Vec3 gsv = norm3_adj(sv, gnd);
    add(gm + 7, dot3(gsv, fz));
    gd = add3(gd, gsv);
    const float g_dn = -2.0f * dot3(gsv, n);
    gn = add3(gn, scale3(-2.0f * dn, gsv));
    gd = add3(gd, scale3(g_dn, n));
    gn = add3(gn, scale3(g_dn, d));
    return norm3(sv.x, sv.y, sv.z);
  }
  // ---- diffuse: cv = ddx bu + ddy (n x bu) + ddz n, bu = norm3(helper x n)
  const float phi = kTwoPi * lobe.z;
  const float sq = sqrtf(lobe.w);
  const float ddx = cosf(phi) * sq;
  const float ddy = sinf(phi) * sq;
  const float ddz = sqrtf(fmaxf(0.0f, 1.0f - lobe.w));
  const bool pick_y = fabsf(n.x) > 0.1f;
  const float ax = pick_y ? 0.0f : 1.0f;
  const float ay = pick_y ? 1.0f : 0.0f;
  const Vec3 bu_raw = {ay * n.z, -ax * n.z, ax * n.y - ay * n.x};
  const Vec3 bu = norm3(bu_raw.x, bu_raw.y, bu_raw.z);
  const Vec3 bv = {n.y * bu.z - n.z * bu.y, n.z * bu.x - n.x * bu.z,
                   n.x * bu.y - n.y * bu.x};
  const Vec3 cv = {ddx * bu.x + ddy * bv.x + ddz * n.x,
                   ddx * bu.y + ddy * bv.y + ddz * n.y,
                   ddx * bu.z + ddy * bv.z + ddz * n.z};
  const Vec3 gcv = norm3_adj(cv, gnd);
  Vec3 gbu = scale3(ddx, gcv);
  const Vec3 gbv = scale3(ddy, gcv);
  gn = add3(gn, scale3(ddz, gcv));
  gn = add3(gn, cross3(bu, gbv));
  gbu = add3(gbu, cross3(gbv, n));
  const Vec3 gb = norm3_adj(bu_raw, gbu);
  gn.x += -ay * gb.z;
  gn.y += ax * gb.z;
  gn.z += ay * gb.x - ax * gb.y;
  return norm3(cv.x, cv.y, cv.z);
}

// Adjoint of the sphere root t(o, d, c, r) (the nearer root above kTMin,
// as nearest_sphere picks it) for the cotangent g_t; adds to the
// cotangents of the centre gc and radius gr, which the caller adds to the
// record once with the normal's.
__device__ __forceinline__ void sphere_t_adjoint(const float* s, Vec3 o,
                                                 Vec3 d, float g_t, Vec3& go,
                                                 Vec3& gd, Vec3& gc,
                                                 float& gr) {
  const Vec3 oc = {o.x - s[0], o.y - s[1], o.z - s[2]};
  const float r = s[3];
  const float half_b = dot3(oc, d);
  const float c = dot3(oc, oc) - r * r;
  const float disc = half_b * half_b - c;
  const float sqrtd = sqrtf(disc);
  const bool near_root = -half_b - sqrtd > kTMin;
  float g_half_b = -g_t;
  const float g_sqrtd = near_root ? -g_t : g_t;
  const float g_disc = g_sqrtd * 0.5f / sqrtd;
  g_half_b += g_disc * 2.0f * half_b;
  const float g_c = -g_disc;
  const Vec3 goc = add3(scale3(2.0f * g_c, oc), scale3(g_half_b, d));
  gd = add3(gd, scale3(g_half_b, oc));
  go = add3(go, goc);
  gc = sub3(gc, goc);
  gr += -2.0f * r * g_c;
}

// Adjoint of the Möller–Trumbore distance t(o, d, v0, e1, e2) for the
// cotangent g_t.
template <class Add>
__device__ __forceinline__ void tri_t_adjoint(const float* t, float* gt,
                                              Vec3 o, Vec3 d, float g_t,
                                              Vec3& go, Vec3& gd,
                                              const Add& add) {
  const Vec3 v0 = {t[0], t[1], t[2]};
  const Vec3 e1 = {t[3], t[4], t[5]};
  const Vec3 e2 = {t[6], t[7], t[8]};
  const Vec3 pv = cross3(d, e2);
  const float det = dot3(e1, pv);
  const float inv_det = 1.0f / det;
  const Vec3 tv = sub3(o, v0);
  const Vec3 qv = cross3(tv, e1);
  const float s = dot3(e2, qv);
  const float g_s = g_t * inv_det;
  const float g_det = -(g_t * s) * inv_det * inv_det;
  Vec3 ge2 = scale3(g_s, qv);
  const Vec3 gqv = scale3(g_s, e2);
  Vec3 ge1 = scale3(g_det, pv);
  const Vec3 gpv = scale3(g_det, e1);
  const Vec3 gtv = cross3(e1, gqv);
  ge1 = add3(ge1, cross3(gqv, tv));
  gd = add3(gd, cross3(e2, gpv));
  ge2 = add3(ge2, cross3(gpv, d));
  go = add3(go, gtv);
  add3_to(add, gt + 0, scale3(-1.0f, gtv));
  add3_to(add, gt + 3, ge1);
  add3_to(add, gt + 6, ge2);
}

// Adjoint of camera_ray for the cotangents of the ray's origin and
// direction, into the thread's camera accumulators gcam[0..18].
__device__ __forceinline__ void camera_adjoint(
    const float* cam, bool has_lens, uint32_t pixel, uint32_t s32,
    uint32_t base, uint32_t seed, float row_f, float col_f, float du,
    float dv, Vec3 go, Vec3 gd, float* gcam) {
  const Uniform4 rg = uniform4(pixel, s32, base, seed);
  const float u = (col_f + rg.x) / du;
  const float v = (row_f + rg.y) / dv;
  Vec3 pre = {cam[3] + u * cam[6] + v * cam[9] - cam[0],
              cam[4] + u * cam[7] + v * cam[10] - cam[1],
              cam[5] + u * cam[8] + v * cam[11] - cam[2]};
  float rad = 0.0f, cp = 0.0f, sp = 0.0f;
  if (has_lens) {
    rad = cam[18] * sqrtf(rg.z);
    const float phi = kTwoPi * rg.w;
    cp = cosf(phi);
    sp = sinf(phi);
    pre.x = pre.x - rad * (cp * cam[12] + sp * cam[15]);
    pre.y = pre.y - rad * (cp * cam[13] + sp * cam[16]);
    pre.z = pre.z - rad * (cp * cam[14] + sp * cam[17]);
  }
  const Vec3 g = norm3_adj(pre, gd);
  const float gv[3] = {g.x, g.y, g.z};
  const float gov[3] = {go.x, go.y, go.z};
  for (int i = 0; i < 3; ++i) {
    gcam[i] += gov[i] - gv[i];
    gcam[3 + i] += gv[i];
    gcam[6 + i] += u * gv[i];
    gcam[9 + i] += v * gv[i];
  }
  if (has_lens) {
    // o = origin + off, pre = (...) - off
    const float goff[3] = {gov[0] - gv[0], gov[1] - gv[1], gov[2] - gv[2]};
    float g_rad = 0.0f;
    for (int i = 0; i < 3; ++i) {
      g_rad += goff[i] * (cp * cam[12 + i] + sp * cam[15 + i]);
      gcam[12 + i] += rad * cp * goff[i];
      gcam[15 + i] += rad * sp * goff[i];
    }
    gcam[18] += g_rad * sqrtf(rg.z);
  }
}

// The vector-Jacobian product of sample s of pixel `pixel` with the
// radiance cotangent gl: traces the sample with a tape (through the
// accessor `tape`), sweeps it in reverse, adds the scene-table cotangents
// through `add` into gsph/gtri (the tables' layouts) and the
// camera's into gcam[0..18].
template <class Tape, class Add>
__device__ __forceinline__ void sample_vjp(
    const float* cam, bool has_lens, const float* sph, float* gsph,
    int n_sph, const float* tri, float* gtri, int n_tri, uint32_t pixel,
    float row_f, float col_f, uint32_t seed, int s, int max_depth, float du,
    float dv, Vec3 gl, const Tape& tape, float* gcam, const Add& add) {
  const uint32_t s32 = static_cast<uint32_t>(s);
  const uint32_t base =
      s32 * (static_cast<uint32_t>(max_depth) * kStreams + 1u);
  Vec3 o0, d0;
  camera_ray(cam, has_lens, pixel, s32, base, seed, row_f, col_f, du, dv, o0,
             d0);
  const int len = trace_taped(sph, n_sph, tri, n_tri, o0, d0, pixel, s32,
                              base, seed, max_depth, tape);

  // cotangents of the state (origin, direction, throughput) that bounce b
  // hands on to bounce b + 1
  Vec3 go = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  Vec3 gt = {0.0f, 0.0f, 0.0f};
  for (int b = len - 1; b >= 0; --b) {
    const TapeEntry e = tape.load(b);
    const Vec3 o = e.o, d = e.d;
    if (e.prim == -1) {
      // ---- miss (the last entry): L += t * (1 - t_sky + k t_sky)
      const float t_sky = 0.5f * (d.y + 1.0f);
      gt = {gl.x * (1.0f - t_sky + 0.5f * t_sky),
            gl.y * (1.0f - t_sky + 0.7f * t_sky),
            gl.z * (1.0f - t_sky + 1.0f * t_sky)};
      const float g_sky = gl.x * e.tr * (0.5f - 1.0f) +
                          gl.y * e.tg * (0.7f - 1.0f) +
                          gl.z * e.tb * (1.0f - 1.0f);
      gd = {0.0f, 0.5f * g_sky, 0.0f};
      go = {0.0f, 0.0f, 0.0f};
      continue;
    }
    const bool is_tri = e.prim <= -2;
    const int k = is_tri ? -e.prim - 2 : e.prim;
    const float* rec = is_tri ? tri + k * kTriFields : sph + k * kSphereFields;
    float* grec = is_tri ? gtri + k * kTriFields : gsph + k * kSphereFields;
    const float* m = rec + (is_tri ? kTriMat : kSphereMat);
    float* gm = grec + (is_tri ? kTriMat : kSphereMat);

    // ---- emission: L += t * emission
    add(gm + 3, gl.x * e.tr);
    add(gm + 4, gl.y * e.tg);
    add(gm + 5, gl.z * e.tb);
    Vec3 gt_in = {gl.x * m[3], gl.y * m[4], gl.z * m[5]};
    Vec3 go_in = {0.0f, 0.0f, 0.0f}, gd_in = {0.0f, 0.0f, 0.0f};
    if (b < len - 1) {
      // the path went on: t' = t * albedo * scale, o' = p + eps osgn n,
      // d' = the scattered direction
      gt_in.x += gt.x * (m[0] * e.scale);
      gt_in.y += gt.y * (m[1] * e.scale);
      gt_in.z += gt.z * (m[2] * e.scale);
      add(gm + 0, gt.x * (e.tr * e.scale));
      add(gm + 1, gt.y * (e.tg * e.scale));
      add(gm + 2, gt.z * (e.tb * e.scale));

      const Vec3 p = {o.x + e.t * d.x, o.y + e.t * d.y, o.z + e.t * d.z};
      Vec3 n, n_raw;
      float inv_r = 0.0f;
      if (is_tri) {
        n = {rec[9], rec[10], rec[11]};
      } else {
        inv_r = 1.0f / rec[3];
        n_raw = {(p.x - rec[0]) * inv_r, (p.y - rec[1]) * inv_r,
                 (p.z - rec[2]) * inv_r};
        n = norm3(n_raw.x, n_raw.y, n_raw.z);
      }
      const bool entering = dot3(d, n) < 0.0f;
      const Vec3 nf = entering ? n : Vec3{-n.x, -n.y, -n.z};
      const uint32_t bounce = base + static_cast<uint32_t>(b) * kStreams;
      const Uniform4 lobe = uniform4(pixel, s32, bounce + kSLobe, seed);
      Vec3 gnf = {0.0f, 0.0f, 0.0f};
      const Vec3 nd = scatter_adjoint(d, nf, entering, m, gm, lobe, pixel,
                                      s32, bounce, seed, gd, gd_in, gnf, add);
      const float osgn = dot3(nd, nf) >= 0.0f ? 1.0f : -1.0f;
      gnf = add3(gnf, scale3(kScatterEps * osgn, go));
      const Vec3 gn = entering ? gnf : Vec3{-gnf.x, -gnf.y, -gnf.z};
      Vec3 gp = go;
      // a sphere's centre and radius cotangents, from the normal and the
      // hit distance, added once
      Vec3 gc = {0.0f, 0.0f, 0.0f};
      float gr = 0.0f;
      if (is_tri) {
        add3_to(add, grec + 9, gn);
      } else {
        const Vec3 gnr = norm3_adj(n_raw, gn);
        gp = add3(gp, scale3(inv_r, gnr));
        gc = scale3(-inv_r, gnr);
        const float g_inv_r = dot3(gnr, sub3(p, {rec[0], rec[1], rec[2]}));
        gr = -g_inv_r * inv_r * inv_r;
      }
      // p = o + t d
      go_in = add3(go_in, gp);
      gd_in = add3(gd_in, scale3(e.t, gp));
      const float g_t = dot3(gp, d);
      if (is_tri) {
        tri_t_adjoint(rec, grec, o, d, g_t, go_in, gd_in, add);
      } else {
        sphere_t_adjoint(rec, o, d, g_t, go_in, gd_in, gc, gr);
        add3_to(add, grec, gc);
        add(grec + 3, gr);
      }
    }
    go = go_in;
    gd = gd_in;
    gt = gt_in;
  }
  camera_adjoint(cam, has_lens, pixel, s32, base, seed, row_f, col_f, du, dv,
                 go, gd, gcam);
}

}  // namespace spira
