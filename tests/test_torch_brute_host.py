"""The brute-force kernels' device code on the CPU: kernel #1's and #4's
table gathers (``csrc/scene_tables.cuh``) and bodies, built as host C++
with g++ and loaded with ctypes, as ``tests/test_torch_counters.py`` builds
kernel #2's body.

* The gathers, fed by the wrappers' own ctypes structs over CPU tensors,
  equal ``pack_tables`` and ``pack_scene_spectral`` to the bit: the demo
  scene, the Cornell box (triangles, a dispersive glass), materials
  without Cauchy coefficients, and scene arrays given as strided views.
* The kept bodies, played on the CPU over the gathered tables, at 37x5
  (ragged against every block), depth 3, spp 1, 3, 16, 17 and 130, each
  pixel written exactly once: #1's (``trace_pixel`` a pixel, over what
  ``gather_tables`` writes) equal to the bit to ``trace_pixel`` over
  ``pack_tables``' tables, #4's (the (pixel, sample) split of
  ``mesh_render.cuh``, over the tables it stages) to
  ``trace_pixel_spectral``'s loop over the pixels.
* The device-constant cache returns one tensor per (table, device), equal
  to the NumPy constants.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch import _build
from spira_tpu_torch.core import colorimetry as cl
from spira_tpu_torch.core.device import device_constant
from spira_tpu_torch.kernels import megakernel as tmk
from spira_tpu_torch.kernels import spectral_fused as tsf

CPU = torch.device("cpu")

HOST_MAIN = r"""
#include <math.h>
#include <algorithm>
#include <cstdint>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
struct float4 {
  float x, y, z, w;
};
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// mesh_render.cuh's device-only body names these; the host never runs it
#define __shared__
struct Dim3 {
  unsigned x, y, z;
};
Dim3 threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
inline bool __any_sync(unsigned, bool pred) { return pred; }
using std::min;
#include "mesh_render.cuh"
#include "scene_tables.cuh"
#include "spectral.cuh"
using namespace spira;

template <class Tables>
std::vector<float> staged(const Tables& t) {
  std::vector<float> s(t.size());
  for (int i = 0; i < t.size(); ++i) s[i] = t.value(i);
  return s;
}

// One pixel's summed radiance, as the kernels trace it.  #1 reads the
// tables laid end to end (what megakernel.cu:gather_tables writes, or
// pack_tables' three tables).
struct Rgb {
  std::vector<float> s;
  BruteIntersect it;
  Rgb(const float* tables, int n_spheres, int n_tris)
      : s(tables, tables + kCamFields + n_spheres * kSphereFields +
                      n_tris * kTriFields),
        it{s.data() + kCamFields, n_spheres,
           s.data() + kCamFields + n_spheres * kSphereFields, n_tris} {}
  Vec3 sample(uint32_t px, float row, float col, uint32_t seed, int s_,
              int depth, float du, float dv, float) const {
    return trace_sample(it, s.data(), s[18] != 0.0f, px, row, col, seed, s_,
                        depth, du, dv);
  }
  Vec3 pixel(uint32_t px, float row, float col, uint32_t seed, int spp,
             int depth, float du, float dv, float) const {
    return trace_pixel(it, s.data(), s[18] != 0.0f, px, row, col, seed, spp,
                       depth, du, dv);
  }
};

struct Spectral {
  std::vector<float> s;
  SpectralBruteIntersect it;
  explicit Spectral(const SpectralTables& t)
      : s(staged(t)),
        it{s.data() + kCamFields + kSkyFields, t.geo.n_spheres,
           s.data() + kCamFields + kSkyFields + t.geo.n_spheres * kSphSpec,
           t.geo.n_tris} {}
  Vec3 sample(uint32_t px, float row, float col, uint32_t seed, int s_,
              int depth, float du, float dv, float film) const {
    return trace_sample_spectral(it, s.data(), s.data() + kCamFields,
                                 s[18] != 0.0f, px, row, col, seed, s_,
                                 depth, du, dv, film);
  }
  Vec3 pixel(uint32_t px, float row, float col, uint32_t seed, int spp,
             int depth, float du, float dv, float film) const {
    return trace_pixel_spectral(it, s.data(), s.data() + kCamFields,
                                s[18] != 0.0f, px, row, col, seed, spp,
                                depth, du, dv, film);
  }
};

// mode 0: trace_pixel's loop over the pixels.  mode 1: the (pixel,
// sample) split (mesh_render.cuh), block by block and round by round, each
// pixel's samples summed by its group's first slot.  visits[p]: the times
// pixel p was written.
template <class Tracer>
void render(const Tracer& tr, int mode, int width, int height, int spp,
            int depth, uint32_t seed, float du, float dv, float inv_spp,
            float film, float* out, int* visits) {
  const int64_t n = static_cast<int64_t>(width) * height;
  const auto write = [&](int64_t p, Vec3 acc) {
    out[3 * p] = acc.x * inv_spp;
    out[3 * p + 1] = acc.y * inv_spp;
    out[3 * p + 2] = acc.z * inv_spp;
    ++visits[p];
  };
  const auto px = [&](int64_t p) {
    write(p, tr.pixel(static_cast<uint32_t>(p),
                      static_cast<float>(p / width),
                      static_cast<float>(p % width), seed, spp, depth, du,
                      dv, film));
  };
  if (mode == 0) {
    for (int64_t p = 0; p < n; ++p) px(p);
  } else {
    const SampleSplit split = sample_split(spp);
    std::vector<float> buf(3 * kSplitThreads);
    for (int64_t b = 0; b < split_blocks(split, n); ++b) {
      std::vector<Vec3> acc(kSplitThreads, Vec3{0.0f, 0.0f, 0.0f});
      for (int r = 0; r < split.rounds; ++r) {
        for (int th = 0; th < kSplitThreads; ++th) {
          const SampleUnit u = sample_unit(split, b, th, n);
          const int s = r * split.chunk + u.j;
          if (!u.live || s >= spp) continue;
          const Vec3 l = tr.sample(static_cast<uint32_t>(u.pixel),
                                   static_cast<float>(u.pixel / width),
                                   static_cast<float>(u.pixel % width), seed,
                                   s, depth, du, dv, film);
          buf[th] = l.x;
          buf[kSplitThreads + th] = l.y;
          buf[2 * kSplitThreads + th] = l.z;
        }
        for (int th = 0; th < kSplitThreads; ++th) {
          const SampleUnit u = sample_unit(split, b, th, n);
          if (!u.live || u.j != 0) continue;
          acc[th] = fold_samples(&buf[th], &buf[kSplitThreads + th],
                                 &buf[2 * kSplitThreads + th],
                                 std::min(split.chunk, spp - r * split.chunk),
                                 acc[th]);
        }
      }
      for (int th = 0; th < kSplitThreads; ++th) {
        const SampleUnit u = sample_unit(split, b, th, n);
        if (u.live && u.j == 0) write(u.pixel, acc[th]);
      }
    }
  }
}

extern "C" {
int rgb_tables_bytes() { return sizeof(RgbTables); }
int spectral_tables_bytes() { return sizeof(SpectralTables); }
int rgb_values(const RgbTables* t, float* out) {
  for (int i = 0; i < t->size(); ++i) out[i] = t->value(i);
  return t->size();
}
int spectral_values(const SpectralTables* t, float* out) {
  for (int i = 0; i < t->size(); ++i) out[i] = t->value(i);
  return t->size();
}
void render_rgb(const float* tables, int n_spheres, int n_tris, int mode,
                int width, int height, int spp, int depth, uint32_t seed,
                float du, float dv, float inv_spp, float* out, int* visits) {
  render(Rgb(tables, n_spheres, n_tris), mode, width, height, spp, depth,
         seed, du, dv, inv_spp, 0.0f, out, visits);
}
void render_spectral(const SpectralTables* t, int mode, int width,
                     int height, int spp, int depth, uint32_t seed, float du,
                     float dv, float inv_spp, float film, float* out,
                     int* visits) {
  render(Spectral(*t), mode, width, height, spp, depth, seed, du, dv,
         inv_spp, film, out, visits);
}
}
"""

#: the work assignments the host program plays: trace_pixel's loop, the
#: (pixel, sample) split
PER_PIXEL, SPLIT = 0, 1


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build of the gathers and bodies, as a ctypes library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on the PATH")
    work = tmp_path_factory.mktemp("brute_host")
    (work / "host.cpp").write_text(HOST_MAIN)
    lib = work / "libbrute_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{_build.CSRC}", str(work / "host.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    assert dll.rgb_tables_bytes() == ctypes.sizeof(tmk._RgbTables)
    assert dll.spectral_tables_bytes() == ctypes.sizeof(tsf._SpectralTables)
    return dll


def _scenes():
    demo = sp.create_scene(device="cpu")
    cornell = sp.create_cornell_box(device="cpu")
    return dict(
        demo=(demo, sp.default_camera(2.0, device="cpu")),
        cornell=(cornell, sp.cornell_camera(37 / 5, device="cpu")),
        lens=(demo, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                   aspect_ratio=2.0, aperture=0.2,
                                   focus_dist=3.0, device="cpu")),
    )


def _values(fn, src, n):
    out = np.full(n, np.nan, np.float32)
    assert fn(ctypes.byref(src), out.ctypes.data_as(ctypes.c_void_p)) == n
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _strided(scene):
    """``scene`` with every sphere, triangle and material array replaced
    by an equal strided view (every other row or element of a larger
    tensor)."""
    def view(t):
        wide = torch.zeros((2 * t.shape[0], *t.shape[1:]), dtype=t.dtype)
        wide[::2] = t
        out = wide[::2]
        assert torch.equal(out, t) and (out.numel() < 2
                                        or not out.is_contiguous())
        return out

    def each(obj, names):
        return dataclasses.replace(
            obj, **{n: view(getattr(obj, n)) for n in names})

    return dataclasses.replace(
        scene,
        spheres=each(scene.spheres, ("centers", "radii", "material")),
        triangles=each(scene.triangles,
                       ("v0", "e1", "e2", "normal", "material")),
        materials=each(scene.materials,
                       ("albedo", "emission", "metallic", "roughness", "ior",
                        "transmission", "cauchy_b")))


@pytest.mark.parametrize("name", ["demo", "cornell", "lens", "strided"])
def test_rgb_gather_equals_pack_tables(host, name):
    scenes = _scenes()
    scene, cam = scenes["cornell" if name == "strided" else name]
    if name == "strided":
        scene = _strided(scene)
    cam_t, sph_t, tri_t = tmk.pack_tables(scene, cam)
    want = torch.cat([cam_t.flatten(), sph_t.flatten(), tri_t.flatten()])
    keep = []
    src = tmk._rgb_tables(scene, cam, CPU, keep)
    got = _values(host.rgb_values, src, want.numel())
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


@pytest.mark.parametrize("name", ["demo", "cornell", "no_cauchy", "strided"])
def test_spectral_gather_equals_pack_scene_spectral(host, name):
    scenes = _scenes()
    scene, cam = scenes["demo" if name == "demo" else "cornell"]
    if name == "strided":
        scene = _strided(scene)
    if name == "no_cauchy":
        assert scene.materials.cauchy_b is not None
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, cauchy_b=None, ior=scene.materials.ior * -1.0))
    sph_t, tri_t = tsf.pack_scene_spectral(scene)
    want = torch.cat([tmk.pack_camera(cam).flatten(),
                      tsf.sky_table(CPU).flatten(), sph_t.flatten(),
                      tri_t.flatten()])
    fits, keep = tsf.cheb_fits(scene.materials), []
    src = tsf._spectral_tables(scene, cam, fits, CPU, keep)
    got = _values(host.spectral_values, src, want.numel())
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def _render(host, spectral, mode, scene, cam, spp, packed=False, width=37,
            height=5, max_depth=3, seed=6):
    """The host program's image and per-pixel write counts; ``packed``:
    #1 over ``pack_tables``' tables instead of the gathered ones."""
    n = width * height
    out = np.full((n, 3), np.nan, np.float32)
    visits = np.zeros(n, np.int32)
    du, dv = tmk._uv_scale(width, height, True)
    common = (mode, width, height, spp, max_depth, seed, ctypes.c_float(du),
              ctypes.c_float(dv), ctypes.c_float(tmk._inv_spp(spp)))
    tail = (out.ctypes.data_as(ctypes.c_void_p),
            visits.ctypes.data_as(ctypes.c_void_p))
    keep = []  # alive while the host reads
    if spectral:
        fits = tsf.cheb_fits(scene.materials)
        src = tsf._spectral_tables(scene, cam, fits, CPU, keep)
        host.render_spectral(ctypes.byref(src), *common,
                             ctypes.c_float(tsf.film_scale()), *tail)
    else:
        s, t = scene.spheres.count, scene.triangles.count
        if packed:
            flat = torch.cat([x.flatten() for x in tmk.pack_tables(
                scene, cam)]).numpy()
        else:
            flat = _values(host.rgb_values,
                           tmk._rgb_tables(scene, cam, CPU, keep),
                           tmk.N_CAM_FIELDS + s * tmk.N_SPHERE_FIELDS
                           + t * tmk.N_TRI_FIELDS)
        host.render_rgb(flat.ctypes.data_as(ctypes.c_void_p), s, t, *common,
                        *tail)
    return out, visits


@pytest.mark.parametrize("spp", [1, 3, 16, 17, 130])
@pytest.mark.parametrize("name", ["demo", "cornell"])
@pytest.mark.parametrize("kernel", ["megakernel", "spectral"])
def test_kept_body_matches_trace_pixel(host, kernel, name, spp):
    """37x5, depth 3: every pixel written exactly once, and the image the
    reference loop's to the bit: #1 a pixel a thread over the gathered
    tables against ``trace_pixel`` over the packed ones, #4's split
    against ``trace_pixel_spectral`` a pixel at a time."""
    scene, cam = _scenes()[name]
    spectral = kernel == "spectral"
    want, once = _render(host, spectral, PER_PIXEL, scene, cam, spp,
                         packed=not spectral)
    got, visits = _render(host, spectral, SPLIT if spectral else PER_PIXEL,
                          scene, cam, spp)
    assert (once == 1).all() and (visits == 1).all()
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_device_constant_cache():
    """One tensor per (table, device), on every call, equal to its NumPy
    constant; the wrappers' constants come from it."""
    for name, values in (("SKY_TABLE", tsf._SKY_TABLE),
                         ("CHEB_PINV", tsf._CHEB_PINV),
                         ("D65_WHITE", cl.D65_WHITE),
                         ("XYZ_TO_SRGB", cl.XYZ_TO_SRGB)):
        a = device_constant(name, values, "cpu")
        b = device_constant(name, values, torch.device("cpu"))
        assert a is b
        np.testing.assert_array_equal(a.numpy(), values)
    assert tsf.sky_table("cpu") is device_constant("SKY_TABLE", None, "cpu")
    np.testing.assert_array_equal(
        tsf.sky_table("cpu").numpy(),
        np.asarray([tsf._SKY_WHITE, tsf._SKY_CYAN, tsf._SKY_BLUE],
                   np.float32))
    xyz = torch.rand(5, 3, generator=torch.Generator().manual_seed(0))
    want = (xyz * torch.from_numpy(cl.D65_WHITE))[..., None, :] \
        * torch.from_numpy(cl.XYZ_TO_SRGB)
    assert torch.equal(cl.xyz_to_rgb(xyz), want.sum(-1))
