// The hero-wavelength spectral tracer: `trace_sample_spectral` traces one
// sample of a pixel, `trace_pixel_spectral` a pixel's samples in order.
//
// `trace_pixel_spectral` is the spectral twin of trace.cuh:trace_pixel and
// the counterpart of spira_tpu_torch/kernels/spectral_fused.py:
// trace_tile_spectral.  It is templated on its intersector, as JAX shares
// trace_tile_spectral between its two spectral kernels through
// `intersect_fn`: the brute force over spectral sphere and triangle records
// (SpectralBruteIntersect) and the packed-BVH walk of bvh.cuh
// (SpectralPackedIntersect) are the RGB intersectors of trace.cuh and
// bvh.cuh at the spectral record strides.
//
// One material layout for every record: the 29-float spectral material
// record `metal rough ior trans cauchy alb[12] emi[12]` (Chebyshev
// coefficients of the albedo and emission SPDs) is a whole row of the
// (M, 29) material table, and sits at offset 4 of a sphere record (33
// floats) and at offset 12 of a triangle record (41 floats), so
// SurfaceHit::mat points at one for every hit.
//
// Per sample: four wavelengths (a hero and three stratified rotations) and
// their unit coordinates, a 4-lane throughput and radiance, and the
// `collapsed` flag of the dispersive hero collapse.  The arithmetic follows
// the plain PyTorch tracer operation by operation, in the same order
// (Clenshaw as ((2*x)*b1 - b2) + c, division by 350 for the unit
// coordinate), under -fmad=false and precise expf/sqrtf/logf/sinf/cosf.
#pragma once

#include <cstdint>

#include "bvh.cuh"
#include "pcg.cuh"
#include "trace.cuh"

namespace spira {

constexpr int kLanes = 4;                  // N_WAVELENGTHS
constexpr int kCheb = 12;                  // N_CHEB
constexpr int kMatSpec = 5 + 2 * kCheb;    // material record: 29 floats
constexpr int kSphSpec = 4 + kMatSpec;     // cx cy cz r | material: 33
constexpr int kTriSpec = 12 + kMatSpec;    // v0 e1 e2 n | material: 41
constexpr int kSkyFields = 3 * kCheb;      // white, cyan, blue coefficients
constexpr int kAlb = 5;                    // offsets inside the material
constexpr int kEmi = 5 + kCheb;
constexpr uint32_t kSWavelength = 10000u;  // hero wavelength + jitter
constexpr uint32_t kSLens = 10001u;        // thin-lens disk sample
constexpr float kLambdaMin = 380.0f;
constexpr float kLambdaRange = 350.0f;

using SpectralBruteIntersect = BruteIntersectT<kSphSpec, kTriSpec>;
template <int kForm>
using SpectralPackedIntersect = PackedIntersect<kForm, kSphSpec, kMatSpec>;

// Clenshaw evaluation of kCheb Chebyshev coefficients at unit-interval x.
__device__ __forceinline__ float cheb(const float* c, float x) {
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int i = kCheb - 1; i >= 1; --i) {
    const float nb1 = 2.0f * x * b1 - b2 + c[i];
    b2 = b1;
    b1 = nb1;
  }
  return x * b1 - b2 + c[0];
}

// Piecewise Gaussian of Wyman et al. 2013: sigma s1 below mu, s2 above.
__device__ __forceinline__ float gauss(float x, float mu, float s1,
                                       float s2) {
  const float s = x < mu ? s1 : s2;
  const float t = (x - mu) / s;
  return expf(-0.5f * t * t);
}

// CIE 1931 2-degree (x, y, z) color matching functions at lam (nm), the
// analytic fits of colorimetry.cmf_xyz_components.
__device__ __forceinline__ Vec3 cmf_xyz(float lam) {
  return {1.056f * gauss(lam, 599.8f, 37.9f, 31.0f) +
              0.362f * gauss(lam, 442.0f, 16.0f, 26.7f) -
              0.065f * gauss(lam, 501.1f, 20.4f, 26.2f),
          0.821f * gauss(lam, 568.8f, 46.9f, 40.5f) +
              0.286f * gauss(lam, 530.9f, 16.3f, 31.1f),
          1.217f * gauss(lam, 437.0f, 11.8f, 36.0f) +
              0.681f * gauss(lam, 459.0f, 26.0f, 13.8f)};
}

// Trace sample s of one pixel; returns its XYZ weighted by film_scale =
// float32(LAMBDA_RANGE / Y_INTEGRAL / 4).  pixel: the PCG counter
// row * width + col (row counted from the image bottom); cam: the 20-float
// camera record; sky: the (3, kCheb) coefficients of the Smits white, cyan
// and blue spectra.  The sample's PCG counters are functions of
// (pixel, s) alone.
template <class Intersect>
__device__ __forceinline__ Vec3 trace_sample_spectral(
    const Intersect& intersect, const float* cam, const float* sky,
    bool has_lens, uint32_t pixel, float row_f, float col_f, uint32_t seed,
    int s, int max_depth, float du, float dv, float film_scale) {
  const uint32_t per_sample = static_cast<uint32_t>(max_depth) * kStreams + 1u;
  const uint32_t s32 = static_cast<uint32_t>(s);
  const uint32_t base = s32 * per_sample;

  // ---- wavelength lanes (hero + stratified rotations); the draw's
  // second and third outputs are the raygen jitter
  const Uniform4 wl = uniform4(pixel, s32, kSWavelength, seed);
  float lam[kLanes], lx[kLanes], white[kLanes], cyan[kLanes], blue[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const float frac = fmodf(wl.x + static_cast<float>(j) * 0.25f, 1.0f);
    lam[j] = kLambdaMin + frac * kLambdaRange;
    lx[j] = 2.0f * (lam[j] - kLambdaMin) / kLambdaRange - 1.0f;
    white[j] = cheb(sky, lx[j]);
    cyan[j] = cheb(sky + kCheb, lx[j]);
    blue[j] = cheb(sky + 2 * kCheb, lx[j]);
  }

  // ---- ray generation (pinhole, or thin lens from its own stream)
  const float u = (col_f + wl.y) / du;
  const float v = (row_f + wl.z) / dv;
  const float dx = cam[3] + u * cam[6] + v * cam[9] - cam[0];
  const float dy = cam[4] + u * cam[7] + v * cam[10] - cam[1];
  const float dz = cam[5] + u * cam[8] + v * cam[11] - cam[2];
  Vec3 o, d;
  if (has_lens) {
    const Uniform4 ln = uniform4(pixel, s32, kSLens, seed);
    const float rad = cam[18] * sqrtf(ln.x);
    const float phi = kTwoPi * ln.y;
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

  float thr[kLanes] = {1.0f, 1.0f, 1.0f, 1.0f};
  float rad[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool collapsed = false;
  for (int b = 0; b < max_depth; ++b) {
    const SurfaceHit h = intersect(o, d);
    if (!h.hit) {
      // ---- sky: single-ordering Smits blend (r <= g <= b always)
      const float t_sky = 0.5f * (d.y + 1.0f);
      const float sky_r = 1.0f - t_sky + 0.5f * t_sky;
      const float sky_g = 1.0f - t_sky + 0.7f * t_sky;
      const float sky_b = 1.0f - t_sky + 1.0f * t_sky;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const float spd = fmaxf(sky_r * white[j] +
                                    (sky_g - sky_r) * cyan[j] +
                                    (sky_b - sky_g) * blue[j],
                                0.0f);
        rad[j] = rad[j] + thr[j] * spd;
      }
      break;
    }
    const float* m = h.mat;
    // ---- emission and albedo at each lane's wavelength
    float alb[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      rad[j] = rad[j] + thr[j] * fmaxf(cheb(m + kEmi, lx[j]), 0.0f);
      alb[j] = fmaxf(cheb(m + kAlb, lx[j]), 0.0f);
    }

    Vec3 n = h.n;
    const bool entering = dot3(d, n) < 0.0f;
    if (!entering) n = {-n.x, -n.y, -n.z};

    const uint32_t bounce = base + static_cast<uint32_t>(b) * kStreams;
    const Uniform4 lobe = uniform4(pixel, s32, bounce + kSLobe, seed);
    const float d_dot_n = dot3(d, n);
    Vec3 nd;
    bool do_collapse = false;
    if (lobe.x < m[0]) {
      // ---- specular lobe: mirror + roughness fuzz
      const Uniform4 f = uniform4(pixel, s32, bounce + kSFuzz, seed);
      float g1, g2, g3, g4;
      box_muller(f.x, f.y, g1, g2);
      box_muller(f.z, f.w, g3, g4);
      const float rx = d.x - 2.0f * d_dot_n * n.x;
      const float ry = d.y - 2.0f * d_dot_n * n.y;
      const float rz = d.z - 2.0f * d_dot_n * n.z;
      const Vec3 fz = norm3(g1, g2, g3);
      const float rough = m[1];
      nd = norm3(rx + rough * fz.x, ry + rough * fz.y, rz + rough * fz.z);
      // ---- dielectric at the hero wavelength: n = ior + B / lam_um^2
      const Uniform4 gl = uniform4(pixel, s32, bounce + kSGlass, seed);
      if (gl.x < m[3]) {
        const float lam_um = lam[0] * 1e-3f;
        const float ior_h = m[2] + m[4] / (lam_um * lam_um);
        const float eta = entering ? 1.0f / ior_h : ior_h;
        const float cos_i = fminf(fmaxf(-d_dot_n, 0.0f), 1.0f);
        const float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
        const bool tir = sin2_t > 1.0f;
        const float q = (1.0f - ior_h) / (1.0f + ior_h);
        const float r0 = q * q;
        const float one_m = 1.0f - cos_i;
        const float schlick =
            r0 + (1.0f - r0) * one_m * one_m * one_m * one_m * one_m;
        if (!(tir || gl.y < schlick)) {
          const float cos_t = sqrtf(1.0f - sin2_t);
          const float k = eta * cos_i - cos_t;
          nd = norm3(eta * d.x + k * n.x, eta * d.y + k * n.y,
                     eta * d.z + k * n.z);
          // a dispersive refraction collapses the path to the hero lane,
          // once per path
          do_collapse = m[4] > 0.0f && !collapsed;
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

    // ---- spectral throughput update, hero collapse, Russian roulette
    float nt[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) nt[j] = thr[j] * alb[j];
    if (do_collapse) {
      nt[0] = nt[0] * static_cast<float>(kLanes);
#pragma unroll
      for (int j = 1; j < kLanes; ++j) nt[j] = 0.0f;
      collapsed = true;
    }
    if (b > kRRStart) {
      float tmax = nt[0];
#pragma unroll
      for (int j = 1; j < kLanes; ++j) tmax = fmaxf(tmax, nt[j]);
      const float p_cont = fminf(fmaxf(tmax, 1e-6f), kRRCap);
      if (lobe.y > p_cont) break;
      const float inv_p = 1.0f / p_cont;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) nt[j] = nt[j] * inv_p;
      tmax = nt[0];
#pragma unroll
      for (int j = 1; j < kLanes; ++j) tmax = fmaxf(tmax, nt[j]);
      if (!(tmax >= kCutoff)) break;
    }

    // offset along the hemisphere the new direction leaves through
    const float osgn = dot3(nd, n) >= 0.0f ? 1.0f : -1.0f;
    o = {h.p.x + kScatterEps * osgn * n.x, h.p.y + kScatterEps * osgn * n.y,
         h.p.z + kScatterEps * osgn * n.z};
    d = nd;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) thr[j] = nt[j];
  }

  // ---- film: spectral radiance -> XYZ (MC over lambda, pdf 1/range)
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const Vec3 c = cmf_xyz(lam[j]);
    sx = sx + rad[j] * c.x;
    sy = sy + rad[j] * c.y;
    sz = sz + rad[j] * c.z;
  }
  return {sx * film_scale, sy * film_scale, sz * film_scale};
}

// Trace `spp` samples of one pixel; returns the summed XYZ, added in sample
// order (as trace.cuh:trace_pixel).
template <class Intersect>
__device__ Vec3 trace_pixel_spectral(const Intersect& intersect,
                                     const float* cam, const float* sky,
                                     bool has_lens, uint32_t pixel,
                                     float row_f, float col_f, uint32_t seed,
                                     int spp, int max_depth, float du,
                                     float dv, float film_scale) {
  float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const Vec3 l = trace_sample_spectral(intersect, cam, sky, has_lens,
                                         pixel, row_f, col_f, seed, s,
                                         max_depth, du, dv, film_scale);
    acc_x = acc_x + l.x;
    acc_y = acc_y + l.y;
    acc_z = acc_z + l.z;
  }
  return {acc_x, acc_y, acc_z};
}

}  // namespace spira
