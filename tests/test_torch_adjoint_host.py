"""The adjoint kernel's device code (``csrc/adjoint.cuh`` over
``trace.cuh`` and ``pcg.cuh``) built as plain host C++ and run one
(pixel, sample) at a time on the CPU, against autograd through the plain
tracer (``grad_tables_plain``): the CPU check of the arithmetic the CUDA
kernels run, before any card sees them.

The headers use no intrinsics, so with ``__device__`` and
``__forceinline__`` defined away a host compiler builds them; the driver
below does what ``csrc/grad_megakernel.cu`` does: loss mode's forward pass
per pixel into a cotangent scratch, then one replay per (pixel, sample)
in the VJP kernel's order, through the same tape accessor and ``Add``
functor, an array in place of the shared-memory tape and a plain ``+=``
in place of the shared-memory atomics.  Built with
``-ffp-contract=off`` as the kernel is with ``-fmad=false``.  Limit: each
table's gradient within 1e-4 relative L2 and the loss within 1e-6
relative; measured at most 1.7e-6 (the Cornell box's camera table).
Skips where no C++ compiler is installed.
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch import _build
from spira_tpu_torch.kernels import grad_megakernel as gk
from spira_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)

REL_L2, LOSS_RTOL = 1e-4, 1e-6

DRIVER = r"""
#include <math.h>
#include <cstdint>
#include <cstdio>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "adjoint.cuh"
using namespace spira;

struct HostAdd {
  void operator()(float* p, float v) const { *p += v; }
};

struct ArrayTape {
  TapeEntry* e;
  void store(int b, const TapeEntry& x) const { e[b] = x; }
  TapeEntry load(int b) const { return e[b]; }
};

// in: int32 S T W H spp grad_spp depth seed has_lens loss_mode; float32 du
// dv inv_spp cot_scale; the camera, sphere, triangle tables; the (W*H, 3)
// target or cotangent.  out: float64 sum of squared residuals; float32
// gradient tables, camera first.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[10];
  float c[4];
  if (fread(h, 4, 10, f) != 10 || fread(c, 4, 4, f) != 4) return 1;
  const int S = h[0], T = h[1], W = h[2], H = h[3], spp = h[4];
  const int gspp = h[5], depth = h[6];
  const uint32_t seed = static_cast<uint32_t>(h[7]);
  const bool lens = h[8] != 0, loss_mode = h[9] != 0;
  const int n_all = kCamFields + S * kSphereFields + T * kTriFields;
  std::vector<float> tab(n_all), g(n_all, 0.0f), pix(3 * W * H);
  if (fread(tab.data(), 4, n_all, f) != static_cast<size_t>(n_all) ||
      fread(pix.data(), 4, pix.size(), f) != pix.size()) return 1;
  fclose(f);
  const float* cam = tab.data();
  const float* sph = cam + kCamFields;
  const float* tri = sph + S * kSphereFields;
  float* gsph = g.data() + kCamFields;
  float* gtri = gsph + S * kSphereFields;
  // loss mode: the forward kernel's pass, the cotangent into a scratch
  std::vector<float> cot(3 * W * H);
  double sq = 0.0;
  float scale = c[3];
  for (int idx = 0; idx < W * H; ++idx) {
    const float* p = pix.data() + 3 * idx;
    if (!loss_mode) {
      for (int k = 0; k < 3; ++k) cot[3 * idx + k] = p[k];
      continue;
    }
    const BruteIntersect isect{sph, S, tri, T};
    const Vec3 a = trace_pixel(isect, cam, lens, static_cast<uint32_t>(idx),
                               static_cast<float>(idx / W),
                               static_cast<float>(idx % W), seed, spp, depth,
                               c[0], c[1]);
    const float r0 = a.x * c[2] - p[0], r1 = a.y * c[2] - p[1];
    const float r2 = a.z * c[2] - p[2];
    sq += r0 * r0 + r1 * r1 + r2 * r2;
    cot[3 * idx + 0] = 2.0f * r0 * c[3];
    cot[3 * idx + 1] = 2.0f * r1 * c[3];
    cot[3 * idx + 2] = 2.0f * r2 * c[3];
  }
  if (loss_mode) scale = 1.0f;
  // the VJP kernel's pass: one replay per (pixel, sample), index
  // pixel * grad_spp + s
  std::vector<double> gcam_sum(kCamFields, 0.0);
  TapeEntry entries[kMaxTape];
  const ArrayTape tape{entries};
  for (int i = 0; i < W * H * gspp; ++i) {
    const int idx = i / gspp, s = i % gspp;
    const float* p = cot.data() + 3 * idx;
    const Vec3 gl = {p[0] * scale, p[1] * scale, p[2] * scale};
    float gcam[kCamFields] = {0.0f};
    sample_vjp(cam, lens, sph, gsph, S, tri, gtri, T,
               static_cast<uint32_t>(idx), static_cast<float>(idx / W),
               static_cast<float>(idx % W), seed, s, depth, c[0], c[1], gl,
               tape, gcam, HostAdd{});
    for (int k = 0; k < kCamFields; ++k) gcam_sum[k] += gcam[k];
  }
  for (int k = 0; k < kCamFields; ++k) g[k] = static_cast<float>(gcam_sum[k]);
  FILE* o = fopen(argv[2], "wb");
  fwrite(&sq, 8, 1, o);
  fwrite(g.data(), 4, n_all, o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_adjoint(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on the PATH")
    work = tmp_path_factory.mktemp("adjoint_host")
    (work / "driver.cpp").write_text(DRIVER)
    exe = work / "driver"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    f"-I{_build.CSRC}", str(work / "driver.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(tables, pix, has_lens, loss_mode, width, height, spp, grad_spp,
            max_depth, seed):
        n = width * height
        du, dv = mk._uv_scale(width, height, True)
        cot_scale = (1.0 / (3 * n * grad_spp) if loss_mode
                     else mk._inv_spp(grad_spp))
        s, t = tables[1].shape[0], tables[2].shape[0]
        with open(work / "in.bin", "wb") as f:
            np.array([s, t, width, height, spp, grad_spp, max_depth, seed,
                      int(has_lens), int(loss_mode)], np.int32).tofile(f)
            np.array([du, dv, mk._inv_spp(spp), cot_scale],
                     np.float32).tofile(f)
            torch.cat([x.reshape(-1) for x in tables]).numpy().tofile(f)
            pix.numpy().tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                       check=True)
        raw = (work / "out.bin").read_bytes()
        g = torch.from_numpy(np.frombuffer(raw[8:], np.float32).copy())
        cuts = np.cumsum([x.numel() for x in tables])[:-1].tolist()
        grads = [x.reshape(t_.shape) for x, t_ in zip(
            torch.tensor_split(g, cuts), tables)]
        loss = float(np.frombuffer(raw[:8], np.float64)[0]) / (3 * n)
        return loss, grads

    return run


def _quad_scene(device):
    """The demo scene plus a 2-triangle back wall."""
    verts = np.array(
        [[-2, -0.5, -1.5], [2, -0.5, -1.5], [2, 1.5, -1.5], [-2, 1.5, -1.5]],
        np.float32,
    )
    quad = sp.make_triangles(verts, np.array([[0, 1, 2], [0, 2, 3]]), 2,
                            device=device)
    return dataclasses.replace(sp.create_scene(device=device),
                               triangles=quad)


def _lens(aspect, device):
    return sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=aspect, aperture=0.2, focus_dist=3.0,
                          device=device)


CASES = {
    # name: (scene, camera, shape, grad_spp, loss mode, seed)
    "demo_vjp": (sp.create_scene, sp.default_camera,
                 dict(width=64, height=32, spp=2, max_depth=4), 2, False, 3),
    "demo_loss_grad_spp1": (sp.create_scene, sp.default_camera,
                            dict(width=64, height=32, spp=2, max_depth=4), 1,
                            True, 11),
    "thin_lens": (sp.create_scene, _lens,
                  dict(width=64, height=32, spp=2, max_depth=3), 2, False, 1),
    # triangles, and Russian roulette from bounce index 4
    "quad_d6": (_quad_scene, sp.default_camera,
                dict(width=64, height=32, spp=2, max_depth=6), 2, False, 2),
    # the dielectric: refraction, Schlick, total internal reflection
    "cornell_d6": (sp.create_cornell_box, sp.cornell_camera,
                   dict(width=32, height=32, spp=2, max_depth=6), 2, False,
                   2),
    # the tape's full depth, at a few pixels, in loss mode
    "cornell_d16_loss": (sp.create_cornell_box, sp.cornell_camera,
                         dict(width=8, height=4, spp=3, max_depth=16), 3,
                         True, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_adjoint_matches_autograd(host_adjoint, name):
    build_scene, build_cam, shape, grad_spp, loss_mode, seed = CASES[name]
    scene = build_scene(device="cpu")
    cam = build_cam(shape["width"] / shape["height"], device="cpu")
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    pix = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 1.0, (shape["width"] * shape["height"], 3)).astype(np.float32))
    loss, grads = host_adjoint(tables, pix, cam.has_lens, loss_mode,
                               grad_spp=grad_spp, seed=seed, **shape)
    want_loss, *want = gk.grad_tables_plain(
        scene, cam, tables, pix, loss_mode=loss_mode, grad_spp=grad_spp,
        seed=seed, **shape)
    if loss_mode:
        assert abs(loss / float(want_loss) - 1.0) <= LOSS_RTOL
    for table, got, ref in zip(("camera", "sphere", "triangle"), grads,
                               want):
        assert torch.isfinite(got).all(), table
        den = float(torch.linalg.norm(ref))
        err = float(torch.linalg.norm(got - ref))
        assert err <= REL_L2 * den, (table, err / max(den, 1e-30))
    assert float(torch.linalg.norm(want[1])) > 0
    if name in ("quad_d6", "cornell_d6", "cornell_d16_loss"):
        assert float(torch.linalg.norm(want[2])) > 0
