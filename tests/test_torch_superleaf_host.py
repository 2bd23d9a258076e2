"""The superleaf kernels' device code (``csrc/superleaf.cuh`` over
``bvh.cuh`` and ``trace.cuh``) built as plain host C++ and run ray by ray
on the CPU, against the plain versions: the block stream of kernels #7
and #8 against ``intersect_mxu_plain``, and the pair walk with superleaf
blocks (#2b) or leaf rows (#2, #3) against ``intersect_packed_plain``.

The headers use no intrinsics but ``__ldg``, so with ``__device__`` and
``__forceinline__`` defined away and ``float4``/``__ldg`` stubbed a host
compiler builds them; built with ``-ffp-contract=off`` as the kernels are
with ``-fmad=false``.  Limit: bit for bit (t, normal, material id and
winner slot equal), which the same operations in the same order give.
Skips where no C++ compiler is installed.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch import _build
from spira_tpu_torch.accel import mxu, pairs
from spira_tpu_torch.kernels import bvh_megakernel as bk
from spira_tpu_torch.kernels import mxu_megakernel as mk

torch.set_num_threads(1)

DRIVER = r"""
#include <math.h>
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
#include "superleaf.cuh"
using namespace spira;

// in: int32 mode n_rays n_pairs n_blocks root; float32 origins (n, 3),
// dirs (n, 3), pairs (P, 16), then mode 0-1: coeff_uv (B*8, 384), coeff_t
// and coeff_pay (B*8, 128); mode 2-3: tri_rows (B, 128).  Modes: 0 the
// block stream, 1 the pair walk over blocks, 2 and 3 over BW and MT rows.
// out: float32 t, normal (n, 3), mat id; int32 slot.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[5];
  if (fread(h, 4, 5, f) != 5) return 1;
  const int mode = h[0], n = h[1], n_pairs = h[2], nb = h[3], root = h[4];
  const size_t n_tab = mode < 2 ? static_cast<size_t>(nb) * 8 * 640
                                : static_cast<size_t>(nb) * 128;
  std::vector<float> rays(6 * n), pr(16 * n_pairs), tab(n_tab);
  if (fread(rays.data(), 4, rays.size(), f) != rays.size() ||
      fread(pr.data(), 4, pr.size(), f) != pr.size() ||
      fread(tab.data(), 4, tab.size(), f) != tab.size()) return 1;
  fclose(f);
  const float* cuv = tab.data();
  const float* ct = cuv + static_cast<size_t>(nb) * 8 * 384;
  const float* cpay = ct + static_cast<size_t>(nb) * 8 * 128;
  const auto* p4 = reinterpret_cast<const float4*>(pr.data());
  const auto* s4 = reinterpret_cast<const float4*>(tab.data());
  std::vector<float> out(5 * n);
  std::vector<int> slot(n);
  for (int i = 0; i < n; ++i) {
    const float* r = rays.data() + 3 * i;
    const Vec3 o = {r[0], r[1], r[2]};
    const Vec3 d = {r[3 * n], r[3 * n + 1], r[3 * n + 2]};
    TriHit th{kInf, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
    if (mode == 0) stream_blocks(cuv, ct, cpay, nb, o, d, th);
    if (mode == 1) walk_packed(p4, BlockLeaves{cuv, ct, cpay}, root, o, d, th);
    if (mode == 2) walk_packed(p4, RowLeaves<kFormBW>{s4}, root, o, d, th);
    if (mode == 3) walk_packed(p4, RowLeaves<kFormMT>{s4}, root, o, d, th);
    out[i] = th.t;
    out[n + 3 * i] = th.n.x;
    out[n + 3 * i + 1] = th.n.y;
    out[n + 3 * i + 2] = th.n.z;
    out[4 * n + i] = th.mid;
    slot[i] = th.slot;
  }
  FILE* g = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), g);
  fwrite(slot.data(), 4, slot.size(), g);
  fclose(g);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on the PATH")
    work = tmp_path_factory.mktemp("superleaf_host")
    (work / "driver.cpp").write_text(DRIVER)
    exe = work / "driver"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    f"-I{_build.CSRC}", str(work / "driver.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(mode, tree, origins, dirs):
        n = origins.shape[0]
        rows = (torch.cat([tree.coeff_uv.reshape(-1), tree.coeff_t.reshape(-1),
                           tree.coeff_pay.reshape(-1)]) if mode < 2
                else tree.tri_rows.reshape(-1))
        pair_rows = (tree.pairs if mode else torch.zeros((0, 16)))
        nb = (tree.coeff_uv.shape[0] // 8 if mode < 2
              else tree.tri_rows.shape[0])
        with open(work / "in.bin", "wb") as f:
            np.array([mode, n, pair_rows.shape[0], nb,
                      tree.root if mode else 0], np.int32).tofile(f)
            for x in (origins, dirs, pair_rows, rows):
                x.numpy().astype(np.float32).tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                       check=True)
        raw = np.fromfile(work / "out.bin", np.float32, count=5 * n)
        slot = np.fromfile(work / "out.bin", np.int32, offset=20 * n)
        return (torch.from_numpy(raw[:n].copy()),
                torch.from_numpy(raw[n:4 * n].reshape(n, 3).copy()),
                torch.from_numpy(raw[4 * n:].astype(np.int32)),
                torch.from_numpy(slot.copy()))

    return run


@pytest.fixture(scope="module")
def scene():
    return sp.create_mesh_scene(subdivisions=2, device="cpu")


def _rays(n, seed):
    """Half aimed at the mesh, half uniform."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = np.array([0.0, 0.1, 0.0], np.float32) - o[: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _assert_same(got, want):
    for name, a, b in zip(("t", "normal", "mat id", "slot"), got, want):
        assert torch.equal(a, b.to(a.dtype)), name


@pytest.mark.parametrize("superleaf", [128, 32])
def test_host_block_stream_matches_plain(host_walk, scene, superleaf):
    """Kernels #7/#8's block stream against ``stream_blocks``."""
    tables = mxu.pack_bvh_mxu(scene.bvh, scene.triangles, superleaf)
    o, d = _rays(512, seed=superleaf)
    best = torch.full((512,), 1e20)
    t, n, mid, slot = mk.stream_blocks(tables, o, d, best)
    assert 100 < int((t < 1e19).sum()) < 512
    _assert_same(host_walk(0, tables, o, d),
                 (t, n, mid.to(torch.int32), slot))


@pytest.mark.parametrize("superleaf", [128, 32])
def test_host_superleaf_walk_matches_plain(host_walk, scene, superleaf):
    """#2b: the pair walk with block leaves against ``packed_walk``."""
    tree = mxu.pack_bvh_superleaf(scene.bvh, scene.triangles, superleaf)
    o, d = _rays(512, seed=superleaf + 1)
    want = bk.intersect_packed_plain(tree, o, d, with_slot=True)
    assert 100 < int((want[0] < 1e19).sum()) < 512
    _assert_same(host_walk(1, tree, o, d), want)


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_host_row_walk_matches_plain(host_walk, scene, form):
    """#2/#3: the same walk template over leaf rows."""
    packed = pairs.pack_bvh(scene.bvh, scene.triangles, form=form)
    o, d = _rays(512, seed=5)
    want = bk.intersect_packed_plain(packed, o, d, with_slot=True)
    _assert_same(host_walk(2 if form == "bw" else 3, packed, o, d), want)
