"""Kernel #2's work counters on the CPU: the counting plain walk behind
``render_bvh_with_counters`` against ``chip_smoke.count_work`` (the plain
walk instrumented from outside), its invariants, and its image against the
uncounted plain render and against the JAX ``render_bvh_with_counters``
run in interpret mode; and the counting kernel's device code
(``trace.cuh:trace_pixel`` over ``bvh.cuh:CountingIntersect``) built as
host C++ with g++, as ``tests/test_torch_superleaf_host.py`` builds the
walk, pixel by pixel against the plain version's per-pixel counts.

The counters are per ray where JAX's are per TPU packet, so only the image
is compared with JAX, at the tolerances of
``tests/test_torch_bvh_megakernel.py`` (channel means within 0.5%, 99% of
pixel-channels within 1e-4).
"""

import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.kernels import bvh_megakernel as jbk
from spira_tpu.scene.scene import create_mesh_scene as j_create_mesh_scene
from spira_tpu_torch import _build
from spira_tpu_torch.accel import mxu
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.kernels import megakernel as tmk

torch.set_num_threads(1)

MEAN_REL, PIX_ATOL, PIX_FRAC = 0.005, 1e-4, 0.99
W, H = 128, 16


@pytest.fixture(scope="module")
def mesh():
    """attach_packed(create_mesh_scene(subdivisions=2)) in both packages,
    the port's from the JAX arrays, and the JAX camera."""
    jscene = j_attach_packed(j_create_mesh_scene(subdivisions=2))
    jcam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          aspect_ratio=W / H)
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (jscene, jcam), (sp.scene_from_numpy(as_np[0], device="cpu"),
                            sp.camera_from_numpy(as_np[1], device="cpu"))


def test_counters_match_count_work_and_image(mesh):
    """64x16, spp 2, depth 3: the image bit-equal to
    ``render_flat_bvh_fused``'s; traversals equal to the live segments
    ``count_work`` sees, and pops, leaf triangles and hits equal to its;
    pops == traversals + pushes; nothing launched."""
    _, (scene, cam) = mesh
    kw = dict(width=64, height=16, spp=2, max_depth=3, seed=2)
    before = tbk.render_bvh_with_counters.launches
    img, c = tbk.render_bvh_with_counters(scene, cam, **kw)
    assert tbk.render_bvh_with_counters.launches == before
    assert torch.equal(img, tbk.render_flat_bvh_fused(scene, cam, **kw))
    assert set(c) == set(tbk.COUNTERS)
    assert c["pops"] == c["traversals"] + c["pushes"]
    assert 0 < c["leaf_visits_primary"] < c["leaf_visits"] <= c["leaf_tris"]
    assert 0 < c["hits"] <= c["traversals"]
    work = chip_smoke.count_work(
        tbk, "make_packed_intersect",
        lambda: tbk.render_flat_bvh_fused(scene, cam, **kw))
    assert c["traversals"] == work["segments"]
    assert c["leaf_tris"] == work["leaf_tris"]
    assert c["pops"] == work["pops"]
    assert c["hits"] == work["hits"]


def test_counters_primary_bounce(mesh):
    """Depth 1: every camera ray walks once and every leaf visit is at
    bounce 0."""
    _, (scene, cam) = mesh
    _, c = tbk.render_bvh_with_counters(scene, cam, width=32, height=8,
                                        spp=2, max_depth=1)
    assert c["traversals"] == 32 * 8 * 2
    assert c["leaf_visits_primary"] == c["leaf_visits"] > 0


def test_counters_per_ray(mesh):
    """The per-pixel counts of the plain version sum to the totals and
    hold the invariant pixel by pixel."""
    _, (scene, cam) = mesh
    flat, counts = tbk.render_bvh_counters_fused(scene, cam, width=16,
                                                 height=8, spp=2,
                                                 max_depth=2)
    assert flat.shape == (128, 3)
    assert all(v.shape == (128,) and v.dtype == torch.int64
               for v in counts.values())
    assert torch.equal(counts["pops"],
                       counts["traversals"] + counts["pushes"])
    assert (counts["traversals"] >= 2).all()


def test_counters_image_matches_jax(mesh):
    """The image against JAX ``render_bvh_with_counters`` (interpret mode)
    on the same scene values and seed, at 128x16, spp 1, depth 2."""
    (jscene, jcam), (scene, cam) = mesh
    kw = dict(width=W, height=H, spp=1, max_depth=2, seed=0)
    want, jctr = jbk.render_bvh_with_counters(jscene, jcam, interpret=True,
                                              **kw)
    want = np.asarray(want)
    got, c = tbk.render_bvh_with_counters(scene, cam, **kw)
    got = got.numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= PIX_ATOL).mean() >= PIX_FRAC
    # both walks visit leaves, at bounce 0 too
    assert jctr["leaf_visits_primary"] > 0 and c["leaf_visits_primary"] > 0


def test_counters_refusals(mesh):
    """The counting walk takes row leaves only; a scene without packed
    tables raises."""
    _, (scene, cam) = mesh
    tree = mxu.pack_bvh_superleaf(scene.bvh, scene.triangles, 128)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3).contiguous()
    with pytest.raises(ValueError):
        tbk.packed_walk(tree, o, d, torch.full((4,), 1e20),
                        counts=tbk.new_counts(4, "cpu"))
    bare = sp.create_mesh_scene(subdivisions=0, device="cpu")
    with pytest.raises(ValueError):
        tbk.render_bvh_with_counters(bare, cam, width=4, height=4, spp=1)


TRACE_MAIN = r"""
#include <math.h>
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <vector>
#define __device__
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
// one thread steps alone: the warp's vote is its own
inline bool __any_sync(unsigned, bool pred) { return pred; }
using std::min;
#include "mesh_render.cuh"
using namespace spira;

// in: int32 form_bw n_sph n_mat n_pairs n_rows root width height spp
// max_depth seed split; float32 du dv inv_spp; camera (20), spheres
// (S, 16), materials (M, 16), pairs (P, 16), tri_rows (R, 128).
// split 0: trace_pixel over each pixel; 1: the kernels' split of
// mesh_render.cuh, block by block and round by round, each (pixel,
// sample) through trace_sample on its own thread slot, each pixel's
// values summed by its group's first slot (fold_samples), its counts
// summed over its samples; 2: kernel #7's split, at least 4 samples a
// thread slot, each slot's samples through trace_samples (path
// regeneration) into the block's value buffer, each pixel's values then
// summed by its group's first slot.
// out: float32 rgb (n, 3); int32 counts (7, n) in WalkCounts order.
template <int kForm>
void run(const std::vector<float>& t, const int* h, const float* f,
         std::vector<float>& rgb, std::vector<int>& counts) {
  const int n_sph = h[1], n_mat = h[2], n_pairs = h[3], root = h[5];
  const int width = h[6], height = h[7], spp = h[8], depth = h[9];
  const float* cam = t.data();
  const float* sph = cam + 20;
  const float* mat = sph + 16 * n_sph;
  const auto* p4 = reinterpret_cast<const float4*>(mat + 16 * n_mat);
  const auto* s4 = reinterpret_cast<const float4*>(
      mat + 16 * n_mat + 16 * n_pairs);
  const int n = width * height;
  const auto add_counts = [&](const WalkCounts& c, int idx) {
    const uint32_t v[kNumCounts] = {c.pops, c.pushes, c.traversals,
                                    c.leaf_visits, c.leaf_tris,
                                    c.leaf_visits_primary, c.hits};
    for (int k = 0; k < kNumCounts; ++k) counts[k * n + idx] += v[k];
  };
  const TreeIntersect<RowLeaves<kForm>> tree{sph, n_sph, mat, p4,
                                             RowLeaves<kForm>{s4}, root};
  if (h[11] == 2) {
    const SampleSplit split = sample_split(spp, kSplitThreads, 4);
    const int per = split.pixels * spp;
    std::vector<float> vals(3 * static_cast<size_t>(per));
    for (int64_t b = 0; b < split_blocks(split, n); ++b) {
      for (int th = 0; th < kSplitThreads; ++th) {
        const SampleUnit u = sample_unit(split, b, th, n);
        if (!u.live) continue;
        const int idx = static_cast<int>(u.pixel);
        float* v = vals.data() + (th / split.chunk) * spp;
        WalkCounts c;
        const CountingIntersect<RowLeaves<kForm>> it{tree, &c};
        trace_samples(it, cam, false, static_cast<uint32_t>(idx),
                      static_cast<float>(idx / width),
                      static_cast<float>(idx % width),
                      static_cast<uint32_t>(h[10]), u.j, split.chunk, spp,
                      depth, f[0], f[1], [&](const Path& p) {
                        v[p.s32] = p.lr;
                        v[per + p.s32] = p.lg;
                        v[2 * per + p.s32] = p.lb;
                      });
        add_counts(c, idx);
      }
      for (int th = 0; th < kSplitThreads; ++th) {
        const SampleUnit u = sample_unit(split, b, th, n);
        if (!u.live || u.j != 0) continue;
        const float* v = vals.data() + (th / split.chunk) * spp;
        const Vec3 acc = fold_samples(v, v + per, v + 2 * per, spp,
                                      Vec3{0.0f, 0.0f, 0.0f});
        rgb[3 * u.pixel] = acc.x * f[2];
        rgb[3 * u.pixel + 1] = acc.y * f[2];
        rgb[3 * u.pixel + 2] = acc.z * f[2];
      }
    }
    return;
  }
  if (h[11]) {
    const SampleSplit split = sample_split(spp);
    std::vector<float> buf(3 * kSplitThreads);
    for (int64_t b = 0; b < split_blocks(split, n); ++b) {
      std::vector<Vec3> acc(kSplitThreads, Vec3{0.0f, 0.0f, 0.0f});
      for (int r = 0; r < split.rounds; ++r) {
        for (int th = 0; th < kSplitThreads; ++th) {
          const SampleUnit u = sample_unit(split, b, th, n);
          const int s = r * split.chunk + u.j;
          if (!u.live || s >= spp) continue;
          const int idx = static_cast<int>(u.pixel);
          WalkCounts c;
          const CountingIntersect<RowLeaves<kForm>> it{tree, &c};
          const Vec3 l = trace_sample(
              it, cam, false, static_cast<uint32_t>(idx),
              static_cast<float>(idx / width),
              static_cast<float>(idx % width), static_cast<uint32_t>(h[10]),
              s, depth, f[0], f[1]);
          buf[th] = l.x;
          buf[kSplitThreads + th] = l.y;
          buf[2 * kSplitThreads + th] = l.z;
          add_counts(c, idx);
        }
        for (int th = 0; th < kSplitThreads; ++th) {
          const SampleUnit u = sample_unit(split, b, th, n);
          if (!u.live || u.j != 0) continue;
          acc[th] = fold_samples(&buf[th], &buf[kSplitThreads + th],
                                 &buf[2 * kSplitThreads + th],
                                 std::min(split.chunk,
                                          spp - r * split.chunk),
                                 acc[th]);
        }
      }
      for (int th = 0; th < kSplitThreads; ++th) {
        const SampleUnit u = sample_unit(split, b, th, n);
        if (!u.live || u.j != 0) continue;
        rgb[3 * u.pixel] = acc[th].x * f[2];
        rgb[3 * u.pixel + 1] = acc[th].y * f[2];
        rgb[3 * u.pixel + 2] = acc[th].z * f[2];
      }
    }
    return;
  }
  for (int idx = 0; idx < n; ++idx) {
    WalkCounts c;
    const CountingIntersect<RowLeaves<kForm>> it{tree, &c};
    static_assert(WantsBounce<CountingIntersect<RowLeaves<kForm>>>::value,
                  "the counting intersector takes the bounce");
    static_assert(!WantsBounce<TreeIntersect<RowLeaves<kForm>>>::value,
                  "the plain intersector does not");
    const Vec3 acc = trace_pixel(it, cam, false, static_cast<uint32_t>(idx),
                                 static_cast<float>(idx / width),
                                 static_cast<float>(idx % width),
                                 static_cast<uint32_t>(h[10]), spp, depth,
                                 f[0], f[1]);
    rgb[3 * idx] = acc.x * f[2];
    rgb[3 * idx + 1] = acc.y * f[2];
    rgb[3 * idx + 2] = acc.z * f[2];
    add_counts(c, idx);
  }
}

int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  int h[12];
  float f[3];
  if (fread(h, 4, 12, in) != 12 || fread(f, 4, 3, in) != 3) return 1;
  const size_t n_tab = 20 + 16 * static_cast<size_t>(h[1] + h[2] + h[3]) +
                       128 * static_cast<size_t>(h[4]);
  std::vector<float> t(n_tab);
  if (fread(t.data(), 4, n_tab, in) != n_tab) return 1;
  fclose(in);
  const int n = h[6] * h[7];
  std::vector<float> rgb(3 * n);
  std::vector<int> counts(kNumCounts * n);
  if (h[0]) {
    run<kFormBW>(t, h, f, rgb, counts);
  } else {
    run<kFormMT>(t, h, f, rgb, counts);
  }
  FILE* out = fopen(argv[2], "wb");
  fwrite(rgb.data(), 4, rgb.size(), out);
  fwrite(counts.data(), 4, counts.size(), out);
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_trace(tmp_path_factory):
    """The counting kernel's body as a host program: (flat rgb, {counter:
    (H*W,) int64}) for a packed scene and pinhole camera, per pixel
    (``trace_pixel``), through the kernels' split (``split=True``) or
    through kernel #7's regenerating split (``split=2``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on the PATH")
    work = tmp_path_factory.mktemp("counting_host")
    (work / "main.cpp").write_text(TRACE_MAIN)
    exe = work / "trace_pixel"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    f"-I{_build.CSRC}", str(work / "main.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(scene, cam, width, height, spp, max_depth, seed, split=False):
        packed = scene.packed
        tables = [tmk.pack_camera(cam), tmk.pack_scene(scene),
                  tbk.pack_materials(scene.materials), packed.pairs,
                  packed.tri_rows]
        du, dv = tmk._uv_scale(width, height, True)
        with open(work / "in.bin", "wb") as f:
            np.array([int(packed.form == "bw"), tables[1].shape[0],
                      tables[2].shape[0], packed.pairs.shape[0],
                      packed.tri_rows.shape[0], packed.root, width, height,
                      spp, max_depth, seed, int(split)],
                     np.int32).tofile(f)
            np.array([du, dv, tmk._inv_spp(spp)], np.float32).tofile(f)
            for t in tables:
                t.detach().numpy().astype(np.float32).tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                       check=True)
        n = width * height
        rgb = np.fromfile(work / "out.bin", np.float32, count=3 * n)
        counts = np.fromfile(work / "out.bin", np.int32, offset=12 * n)
        return (torch.from_numpy(rgb.reshape(n, 3).copy()),
                {k: torch.from_numpy(counts[i * n:(i + 1) * n].astype(
                    np.int64)) for i, k in enumerate(tbk.COUNTERS)})

    return run


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_host_counting_kernel_body_matches_plain(host_trace, mesh, form):
    """32x16, spp 2, depth 1: the counting kernel's per-pixel body counts
    exactly what the plain walk counts for each pixel (the camera rays and
    their walks use only IEEE operations), and its image equals the plain
    version's.  Depth 3: the frame's totals within 1% (the scatter's
    sinf/cosf/logf are the host library's here, PyTorch's in the plain
    version, so a last-bit difference may send a path elsewhere)."""
    _, (scene, cam) = mesh
    scene = sp.attach_packed(scene, form=form)
    kw = dict(width=32, height=16, spp=2, seed=4)
    rgb, counts = host_trace(scene, cam, max_depth=1, **kw)
    want, want_counts = tbk.render_bvh_counters_fused(scene, cam,
                                                      max_depth=1, **kw)
    assert torch.equal(rgb, want)
    for k in tbk.COUNTERS:
        assert torch.equal(counts[k], want_counts[k]), k
    assert counts["leaf_visits_primary"].sum() > 0
    _, counts = host_trace(scene, cam, max_depth=3, **kw)
    _, want_counts = tbk.render_bvh_counters_fused(scene, cam, max_depth=3,
                                                   **kw)
    for k in tbk.COUNTERS:
        got, ref = int(counts[k].sum()), int(want_counts[k].sum())
        assert abs(got - ref) <= 0.01 * ref, k
    assert int(counts["leaf_visits_primary"].sum()) < int(
        counts["leaf_visits"].sum())


@pytest.mark.parametrize("spp", [1, 3, 16, 17, 130])
def test_host_split_matches_trace_pixel(host_trace, mesh, spp):
    """The kernels' work split (``mesh_render.cuh``: one slot a (pixel,
    sample), a pixel's values summed in sample order by its group's first
    slot, in one round or, past 128 samples, several) against
    ``trace_pixel``'s loop over the samples of each pixel, at 37x5
    (ragged against every block), depth 3: the image bit for bit, and each
    pixel's counts, summed over its samples, equal."""
    _, (scene, cam) = mesh
    scene = sp.attach_packed(scene, form="bw")
    kw = dict(width=37, height=5, spp=spp, max_depth=3, seed=6)
    rgb, counts = host_trace(scene, cam, **kw)
    got, got_counts = host_trace(scene, cam, split=True, **kw)
    assert torch.equal(got, rgb)
    for k in tbk.COUNTERS:
        assert torch.equal(got_counts[k], counts[k]), k
    assert counts["leaf_visits"].sum() > 0


@pytest.mark.parametrize("spp", [1, 3, 16, 17, 130])
def test_host_regen_split_matches_trace_pixel(host_trace, mesh, spp):
    """Kernel #7's split (``mesh_render.cuh:render_mesh_regen``: at least
    4 samples a thread slot, each slot tracing its samples with path
    regeneration, ``trace_samples``, into a value buffer that each pixel's
    group's first slot sums in sample order) against ``trace_pixel`` at
    37x5, depth 3: the image bit for bit, and each pixel's counts equal,
    so every sample ran trace_sample's bounces."""
    _, (scene, cam) = mesh
    scene = sp.attach_packed(scene, form="bw")
    kw = dict(width=37, height=5, spp=spp, max_depth=3, seed=6)
    rgb, counts = host_trace(scene, cam, **kw)
    got, got_counts = host_trace(scene, cam, split=2, **kw)
    assert torch.equal(got, rgb)
    for k in tbk.COUNTERS:
        assert torch.equal(got_counts[k], counts[k]), k
    assert counts["traversals"].sum() > 37 * 5 * spp
