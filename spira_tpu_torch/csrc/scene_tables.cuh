// The tables the brute-force kernels (#1 csrc/megakernel.cu, #4
// csrc/spectral_megakernel.cu) read, straight from the scene's own arrays:
// a forward frame gathers its records on the card, with no packing
// launches of torch ops before it (#1 in a gather kernel ahead of the
// render launch, #4 while it stages them into shared memory).
//
// Each record is the one spira_tpu_torch/kernels/megakernel.py:pack_tables
// (RGB) or kernels/spectral_fused.py:pack_scene_spectral (spectral) builds
// on the host, value for value: the gathers copy floats and do no
// arithmetic (the one exception, a missing Cauchy coefficient, is
// `ior * 0.0f`, the plain version's own product).  `value(i)` is float i of
// the tables laid end to end (camera | [sky |] spheres | triangles).
//
// Everything here builds as host C++ (tests/test_torch_brute_host.py holds
// the gathers against pack_tables and pack_scene_spectral to the bit).
#pragma once

#include <cstdint>
#include <cstdlib>

#include "spectral.cuh"
#include "trace.cuh"

namespace spira {

// A material index outside the table stops the kernel (a device-side
// error, as the plain version's gather raises) instead of reading past it.
__device__ __forceinline__ int checked_material(int32_t m, int n_mats) {
#ifdef __CUDA_ARCH__
  if (m < 0 || m >= n_mats) __trap();
#else
  if (m < 0 || m >= n_mats) std::abort();
#endif
  return m;
}

// The camera's own tensors: origin, lower-left corner, horizontal,
// vertical, u, v (3 floats each) and lens_radius (1).
struct CameraFields {
  const float* origin;
  const float* llc;
  const float* horizontal;
  const float* vertical;
  const float* u;
  const float* v;
  const float* lens_radius;

  // Field f of pack_camera's 20-float record.
  __device__ __forceinline__ float value(int f) const {
    if (f >= 18) return f == 18 ? lens_radius[0] : 0.0f;
    const float* vec;
    switch (f / 3) {
      case 0: vec = origin; break;
      case 1: vec = llc; break;
      case 2: vec = horizontal; break;
      case 3: vec = vertical; break;
      case 4: vec = u; break;
      default: vec = v; break;
    }
    return vec[f % 3];
  }
};

// Spheres and triangles as the scene holds them: (S, 3) centers, (S,)
// radii and material indices; (T, 3) v0, e1, e2, unit normal and (T,)
// material indices.
struct GeometryFields {
  const float* centers;
  const float* radii;
  const int32_t* sph_mat;
  int n_spheres;
  const float* v0;
  const float* e1;
  const float* e2;
  const float* normal;
  const int32_t* tri_mat;
  int n_tris;

  // Field f < 4 of sphere k's record: center, radius.
  __device__ __forceinline__ float sphere(int k, int f) const {
    return f < 3 ? centers[3 * k + f] : radii[k];
  }
  // Field f < 12 of triangle k's record: v0, e1, e2, normal.
  __device__ __forceinline__ float tri(int k, int f) const {
    const float* vec;
    switch (f / 3) {
      case 0: vec = v0; break;
      case 1: vec = e1; break;
      case 2: vec = e2; break;
      default: vec = normal; break;
    }
    return vec[3 * k + f % 3];
  }
};

// The RGB materials: (M, 3) albedo and emission, (M,) metallic,
// roughness, ior and transmission.
struct RgbMaterialFields {
  const float* albedo;
  const float* emission;
  const float* metallic;
  const float* roughness;
  const float* ior;
  const float* transmission;
  int n_mats;

  // Field f of material m's 12-float record (pack_scene's columns 4-15):
  // albedo3 emission3 metallic roughness ior transmission, 2 zeros.
  __device__ __forceinline__ float value(int m, int f) const {
    switch (f) {
      case 0: case 1: case 2: return albedo[3 * m + f];
      case 3: case 4: case 5: return emission[3 * m + f - 3];
      case 6: return metallic[m];
      case 7: return roughness[m];
      case 8: return ior[m];
      case 9: return transmission[m];
      default: return 0.0f;
    }
  }
};

// Kernel #1's tables: pack_camera (20) | pack_scene (S, 16) |
// pack_triangles (T, 24), gathered by megakernel.cu:gather_tables.
struct RgbTables {
  CameraFields camera;
  GeometryFields geo;
  RgbMaterialFields mats;

  __host__ __device__ __forceinline__ int size() const {
    return kCamFields + geo.n_spheres * kSphereFields +
           geo.n_tris * kTriFields;
  }

  __device__ __forceinline__ float value(int i) const {
    if (i < kCamFields) return camera.value(i);
    i -= kCamFields;
    if (i < geo.n_spheres * kSphereFields) {
      const int k = i / kSphereFields, f = i % kSphereFields;
      return f < 4 ? geo.sphere(k, f)
                   : mats.value(checked_material(geo.sph_mat[k],
                                                 mats.n_mats), f - 4);
    }
    i -= geo.n_spheres * kSphereFields;
    const int k = i / kTriFields, f = i % kTriFields;
    return f < 12 ? geo.tri(k, f)
                  : mats.value(checked_material(geo.tri_mat[k], mats.n_mats),
                               f - 12);
  }
};

// The spectral materials: (M,) metallic, roughness, ior, transmission and
// Cauchy coefficient (null: none, `ior * 0.0f` as the plain version
// fills it), and the (M, kCheb) Chebyshev fits of the albedo and emission
// SPDs at row stride `cheb_rs` and column stride `cheb_cs` (the fits are
// torch ops ahead of the launch; their layout is the product's).
struct SpectralMaterialFields {
  const float* metallic;
  const float* roughness;
  const float* ior;
  const float* transmission;
  const float* cauchy;
  const float* alb_cheb;
  const float* emi_cheb;
  int64_t cheb_rs, cheb_cs;
  int n_mats;

  // Field f of material m's 29-float record (pack_materials_spectral).
  __device__ __forceinline__ float value(int m, int f) const {
    switch (f) {
      case 0: return metallic[m];
      case 1: return roughness[m];
      case 2: return ior[m];
      case 3: return transmission[m];
      case 4: return cauchy ? cauchy[m] : ior[m] * 0.0f;
      default: break;
    }
    const float* fit = f < kEmi ? alb_cheb : emi_cheb;
    const int d = f < kEmi ? f - kAlb : f - kEmi;
    return fit[m * cheb_rs + d * cheb_cs];
  }
};

// Kernel #4's tables: pack_camera (20) | the sky's (3, kCheb) coefficients
// | spheres (S, 33) | triangles (T, 41) of pack_scene_spectral.
struct SpectralTables {
  CameraFields camera;
  const float* sky;
  GeometryFields geo;
  SpectralMaterialFields mats;

  __host__ __device__ __forceinline__ int size() const {
    return kCamFields + kSkyFields + geo.n_spheres * kSphSpec +
           geo.n_tris * kTriSpec;
  }

  __device__ __forceinline__ float value(int i) const {
    if (i < kCamFields) return camera.value(i);
    i -= kCamFields;
    if (i < kSkyFields) return sky[i];
    i -= kSkyFields;
    if (i < geo.n_spheres * kSphSpec) {
      const int k = i / kSphSpec, f = i % kSphSpec;
      return f < 4 ? geo.sphere(k, f)
                   : mats.value(checked_material(geo.sph_mat[k],
                                                 mats.n_mats), f - 4);
    }
    i -= geo.n_spheres * kSphSpec;
    const int k = i / kTriSpec, f = i % kTriSpec;
    return f < 12 ? geo.tri(k, f)
                  : mats.value(checked_material(geo.tri_mat[k], mats.n_mats),
                               f - 12);
  }
};

#ifdef __CUDACC__
// Kernel #4's staging, called by every thread of the block: the tables
// laid end to end into shared memory at dst (the caller synchronises the
// block after it).
template <class Tables>
__device__ __forceinline__ void stage_tables(float* dst, const Tables& t) {
  const int n = t.size();
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = t.value(i);
}
#endif

}  // namespace spira
