"""The superleaf kernels' device code (``csrc/superleaf.cuh`` over
``bvh.cuh`` and ``trace.cuh``) built as plain host C++ and run ray by ray
on the CPU, against the plain versions: the lane-record stream of kernels
#7 and #8 (``stream_records`` over each block's real lanes, R rays a
thread as #8 holds them) against ``intersect_mxu_plain``, and the pair
walk with superleaf blocks (#2b) or leaf rows (#2, #3) against
``intersect_packed_plain``, on the mesh scene and on a tree as deep as the
walk's stack allows, through a stack accessor that records how deep the
walk stacks.

The headers use no intrinsics but ``__ldg``, so with ``__device__`` and
``__forceinline__`` defined away and ``float4``/``__ldg`` stubbed a host
compiler builds them; built with ``-ffp-contract=off`` as the kernels are
with ``-fmad=false``.  Limit: bit for bit (t, normal, material id and
winner slot equal), which the same operations in the same order give.
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
from spira_tpu_torch.accel import bvh, mxu, pairs
from spira_tpu_torch.kernels import bvh_megakernel as bk
from spira_tpu_torch.kernels import mxu_megakernel as mk
from spira_tpu_torch.scene.obj import icosphere

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

// in: int32 mode n_rays n_pairs n_blocks root rays n_lanes; float32
// origins (n, 3), dirs (n, 3), pairs (P, 16), then modes 0 and 1:
// coeff_pay (B*8, 128), the lane records (L, 24) and int32 offsets (B + 1);
// modes 2-8: tri_rows (B, 128).  Modes:
// 0 the lane-record stream (`rays` rays a thread: 1, 2 or 4), 1 the pair
// walk over blocks (RecordLeaves), 2 and 3 over BW and MT rows, 4 and 5
// the same walks counting (WalkCounts, bounce 0), 6 the BW walk over
// HostStack, 7 and 8 the BW and MT walks loading leaf triangles 4 at a
// time (kernel #3's RowLeaves<kForm, 4>).
// out: float32 t, normal (n, 3), mat id; int32 slot; modes 4-5: int32
// pops, pushes, traversals, leaf_visits, leaf_tris, leaf_visits_primary
// (6, n); mode 6: int32 the deepest stack (n).

// The walk's stack as a bounds-checked vector that records the most
// entries it held.
struct HostStack {
  std::vector<int> s = std::vector<int>(kStackSize);
  int deepest = 0;
  void put(int i, int v) {
    s.at(i) = v;
    deepest = i + 1 > deepest ? i + 1 : deepest;
  }
  int get(int i) const { return s.at(i); }
};
// The lane-record stream of rays i .. i + R - 1 (a ray past n tests
// zeros, as in kernel #8), each ray's winner payload read after it.
template <int R>
void stream_rays(const float4* rec, const int* off, int nb,
                 const float* cpay, const float* rays, int n, int i,
                 TriHit* th) {
  LaneHits<R> h;
  for (int k = 0; k < R; ++k) {
    Vec3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
    if (i + k < n) {
      const float* r = rays + 3 * (i + k);
      o = {r[0], r[1], r[2]};
      d = {r[3 * n], r[3 * n + 1], r[3 * n + 2]};
    }
    h.ray[k] = lane_ray(o, d);
    h.t[k] = kInf;
    h.slot[k] = -1;
  }
  stream_records<R>(rec, off, nb, h, SharedLoad{});
  for (int k = 0; k < R && i + k < n; ++k) {
    th[k] = {h.t[k], {0.0f, 0.0f, 0.0f}, -1.0f, h.slot[k]};
    if (h.slot[k] >= 0) lane_payload(cpay, h.slot[k], th[k]);
  }
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[7];
  if (fread(h, 4, 7, f) != 7) return 1;
  const int mode = h[0], n = h[1], n_pairs = h[2], nb = h[3], root = h[4];
  const int rays_a_thread = h[5], n_lanes = h[6];
  const bool blocks = mode < 2;
  const size_t n_tab =
      blocks ? static_cast<size_t>(nb) * 8 * 128 + n_lanes * 24
             : static_cast<size_t>(nb) * 128;
  std::vector<float> rays(6 * n), pr(16 * n_pairs), tab(n_tab);
  std::vector<int> off(blocks ? nb + 1 : 0);
  if (fread(rays.data(), 4, rays.size(), f) != rays.size() ||
      fread(pr.data(), 4, pr.size(), f) != pr.size() ||
      fread(tab.data(), 4, tab.size(), f) != tab.size() ||
      fread(off.data(), 4, off.size(), f) != off.size()) return 1;
  fclose(f);
  const float* cpay = tab.data();
  const auto* rec = reinterpret_cast<const float4*>(
      cpay + static_cast<size_t>(nb) * 8 * 128);
  const auto* p4 = reinterpret_cast<const float4*>(pr.data());
  const auto* s4 = reinterpret_cast<const float4*>(tab.data());
  std::vector<float> out(5 * n);
  std::vector<int> slot(n), counts(6 * n);
  std::vector<TriHit> streamed(n);
  for (int i = 0; mode == 0 && i < n; i += rays_a_thread) {
    if (rays_a_thread == 1) stream_rays<1>(rec, off.data(), nb, cpay,
                                           rays.data(), n, i, &streamed[i]);
    if (rays_a_thread == 2) stream_rays<2>(rec, off.data(), nb, cpay,
                                           rays.data(), n, i, &streamed[i]);
    if (rays_a_thread == 4) stream_rays<4>(rec, off.data(), nb, cpay,
                                           rays.data(), n, i, &streamed[i]);
  }
  for (int i = 0; i < n; ++i) {
    const float* r = rays.data() + 3 * i;
    const Vec3 o = {r[0], r[1], r[2]};
    const Vec3 d = {r[3 * n], r[3 * n + 1], r[3 * n + 2]};
    TriHit th{kInf, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
    if (mode == 0) th = streamed[i];
    if (mode == 1) {
      walk_packed(p4, RecordLeaves{rec, off.data(), cpay}, root, o, d, th);
    }
    if (mode == 2) walk_packed(p4, RowLeaves<kFormBW>{s4}, root, o, d, th);
    if (mode == 3) walk_packed(p4, RowLeaves<kFormMT>{s4}, root, o, d, th);
    WalkCounts c;
    if (mode == 4) walk_packed(p4, RowLeaves<kFormBW>{s4}, root, o, d, th, c);
    if (mode == 5) walk_packed(p4, RowLeaves<kFormMT>{s4}, root, o, d, th, c);
    const uint32_t v[6] = {c.pops, c.pushes, c.traversals, c.leaf_visits,
                           c.leaf_tris, c.leaf_visits_primary};
    for (int k = 0; k < 6; ++k) counts[k * n + i] = static_cast<int>(v[k]);
    if (mode == 6) {
      NoCount none;
      HostStack stack;
      walk_packed(p4, RowLeaves<kFormBW>{s4}, root, o, d, th, none, stack);
      counts[i] = stack.deepest;
    }
    if (mode == 7) walk_packed(p4, RowLeaves<kFormBW, 4>{s4}, root, o, d, th);
    if (mode == 8) walk_packed(p4, RowLeaves<kFormMT, 4>{s4}, root, o, d, th);
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
  if (mode == 6) fwrite(counts.data(), 4, n, g);
  if (mode == 4 || mode == 5) fwrite(counts.data(), 4, counts.size(), g);
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

    def run(mode, tree, origins, dirs, rays=1, lanes=None):
        n = origins.shape[0]
        blocks = mode in (0, 1)
        if lanes is None and blocks:
            lanes = tree.lanes
        rows = (torch.cat([tree.coeff_pay.reshape(-1),
                           lanes.records.reshape(-1)]) if blocks
                else tree.tri_rows.reshape(-1))
        pair_rows = (tree.pairs if mode else torch.zeros((0, 16)))
        nb = (tree.coeff_uv.shape[0] // 8 if blocks
              else tree.tri_rows.shape[0])
        with open(work / "in.bin", "wb") as f:
            np.array([mode, n, pair_rows.shape[0], nb,
                      tree.root if mode else 0, rays,
                      lanes.n_lanes if blocks else 0], np.int32).tofile(f)
            for x in (origins, dirs, pair_rows, rows):
                x.numpy().astype(np.float32).tofile(f)
            if blocks:
                lanes.offsets.numpy().astype(np.int32).tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                       check=True)
        raw = np.fromfile(work / "out.bin", np.float32, count=5 * n)
        slot = np.fromfile(work / "out.bin", np.int32, offset=20 * n,
                           count=n)
        out = (torch.from_numpy(raw[:n].copy()),
               torch.from_numpy(raw[n:4 * n].reshape(n, 3).copy()),
               torch.from_numpy(raw[4 * n:].astype(np.int32)),
               torch.from_numpy(slot.copy()))
        if mode < 4 or mode > 6:
            return out
        counts = np.fromfile(work / "out.bin", np.int32, offset=24 * n)
        return out, torch.from_numpy(counts.reshape(-1, n).copy())

    return run


def deep_tree_scene(levels, device="cpu", form="bw"):
    """A packed scene whose pair tree is ``levels`` records deep, and on
    which a ray down -z through the middle keeps one far child on the
    walk's stack a level: spine node k holds spine node k + 1 (the nearer
    child) and a side node of two one-triangle leaves (the farther); the
    last spine node holds two leaves at z = -1 and -1.25, and the side
    nodes' triangles lie behind them, the deepest side node nearest.  Each
    triangle spans x, y in [-2, 2]."""
    zs = [-1.0, -1.25]
    for k in range(levels - 1):
        z = -2.0 - 0.5 * (levels - 2 - k)
        zs += [z, z - 0.25]
    verts = [(x, y, z) for z in zs
             for x, y in ((-2.0, -2.0), (2.0, -2.0), (0.0, 2.0))]
    faces = np.arange(3 * len(zs)).reshape(-1, 3)
    tris = sp.make_triangles(verts, faces, np.arange(len(zs)) % 2,
                             device="cpu")
    lo = np.array([[-2.0, -2.0, z] for z in zs], np.float32)
    hi = np.array([[2.0, 2.0, z] for z in zs], np.float32)
    node_min, node_max, left, right, is_leaf = [], [], [], [], []

    def alloc():  # preorder: the root is node 0
        for col in (node_min, node_max, left, right, is_leaf):
            col.append(0)
        return len(left) - 1

    def leaf(t):
        i = alloc()
        node_min[i], node_max[i], left[i], right[i], is_leaf[i] = (
            lo[t], hi[t], t, 1, 1)
        return i

    def internal(i, a, b):
        left[i], right[i] = a, b
        node_min[i] = np.minimum(node_min[a], node_min[b])
        node_max[i] = np.maximum(node_max[a], node_max[b])

    def side(k):
        i = alloc()
        internal(i, leaf(2 + 2 * k), leaf(3 + 2 * k))
        return i

    spine = [alloc() for _ in range(levels)]
    for k in reversed(range(levels)):
        if k == levels - 1:
            internal(spine[k], leaf(0), leaf(1))
        else:
            internal(spine[k], spine[k + 1], side(k))
    tree = bvh._flat(np.array(node_min), np.array(node_max), left, right,
                     is_leaf, np.arange(len(zs)))
    materials = sp.make_materials([
        dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
        dict(albedo=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.1),
    ], device="cpu")
    scene = sp.make_scene(triangles=tris, materials=materials, bvh=tree)
    return sp.attach_packed(scene, form=form).to(device)


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
    """Kernels #7/#8's block stream, one ray a thread over the lane
    records of each block's real lanes (``stream_records``), against
    ``stream_blocks`` over the packed tables."""
    tables = mxu.pack_bvh_mxu(scene.bvh, scene.triangles, superleaf)
    o, d = _rays(512, seed=superleaf)
    best = torch.full((512,), 1e20)
    t, n, mid, slot = mk.stream_blocks(tables, o, d, best)
    assert 100 < int((t < 1e19).sum()) < 512
    _assert_same(host_walk(0, tables, o, d),
                 (t, n, mid.to(torch.int32), slot))


@pytest.mark.parametrize("superleaf", [128, 32])
def test_host_superleaf_walk_matches_plain(host_walk, scene, superleaf):
    """#2b: the pair walk with block leaves (``RecordLeaves``: a block's
    real lanes as lane records, the payload read once a visit) against
    ``packed_walk`` over the packed tables."""
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


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_host_counting_walk_matches_plain(host_walk, scene, form):
    """#2's counting build: the walk with WalkCounts gives the same hits,
    and per ray the counts of ``packed_walk(..., counts=...)`` at bounce
    0 (pops, pushes, traversals, leaf visits, leaf triangles, primary
    visits)."""
    packed = pairs.pack_bvh(scene.bvh, scene.triangles, form=form)
    o, d = _rays(512, seed=7)
    counts = bk.new_counts(512, "cpu")
    t, n, mid, slot = bk.packed_walk(packed, o, d, torch.full((512,), 1e20),
                                     counts=counts, primary=True)
    got, got_counts = host_walk(4 if form == "bw" else 5, packed, o, d)
    _assert_same(got, (t, n, mid.to(torch.int32), slot))
    for k, name in enumerate(bk.COUNTERS[:6]):
        assert torch.equal(got_counts[k].long(), counts[name]), name
    assert (counts["traversals"] == 1).all()
    assert counts["leaf_tris"].sum() > counts["leaf_visits"].sum() > 0


def test_host_walk_deep_tree_matches_plain(host_walk):
    """A tree as deep as the walk's stack (128 pair records): rays down -z
    through its middle hit the nearest triangle, as the plain walk finds
    it, and the walk, through the ``HostStack`` accessor, holds one far
    child a level: all 128 entries of the stack at the deepest level."""
    packed = deep_tree_scene(pairs.TRAVERSAL_STACK).packed
    assert packed.depth == pairs.TRAVERSAL_STACK
    rng = np.random.default_rng(11)
    n = 256
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.ones((n, 1))], 1)
    d = np.concatenate([rng.uniform(-0.01, 0.01, (n, 2)),
                        -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    want = bk.intersect_packed_plain(packed, o, d, with_slot=True)
    got, deepest = host_walk(6, packed, o, d)
    _assert_same(got, want)
    assert (want[3] == 0).all()  # the nearest triangle, at z = -1
    assert (deepest[0] == pairs.TRAVERSAL_STACK).all()


def twin_mesh_scene():
    """An icosphere whose every triangle is there twice, in materials 0
    and 1, on the CPU with its BVH: every hit is a tie of two triangles at
    equal t, which the first in slot order wins."""
    mesh = icosphere(center=(0.0, 0.1, 0.0), radius=0.6, subdivisions=2,
                     material=0)
    v0 = mesh.v0.numpy()
    verts = np.stack([v0, v0 + mesh.e1.numpy(), v0 + mesh.e2.numpy()], 1)
    faces = np.repeat(np.arange(3 * mesh.count).reshape(-1, 3), 2, axis=0)
    tris = sp.make_triangles(verts.reshape(-1, 3), faces,
                             np.tile([0, 1], mesh.count), device="cpu")
    materials = sp.make_materials([dict(albedo=(0.7, 0.3, 0.3)),
                                   dict(albedo=(0.3, 0.3, 0.7))],
                                  device="cpu")
    return sp.make_scene(triangles=tris, materials=materials,
                         bvh=bvh.build_bvh_for_triangles(tris))


def twin_scene(form):
    """:func:`twin_mesh_scene`'s packed tables in leaf form ``form``."""
    return sp.attach_packed(twin_mesh_scene(), form=form).packed


@pytest.mark.parametrize("tree", ["mesh bw", "mesh mt", "twins bw",
                                  "twins mt", "deep bw"])
def test_host_batched_leaf_walk_matches_plain(host_walk, scene, tree):
    """Kernel #3's walk, whose leaf visit loads 4 triangles' rows before
    it tests them (``RowLeaves<kForm, 4>``): the plain walk's hits to the
    bit, on the mesh scene (leaves of one and two rows, so batches of 4
    end inside a row and across one) and on twinned triangles (every hit
    a tie, decided by slot order) in both leaf forms, and on a tree as
    deep as the walk's stack allows."""
    kind, form = tree.split()
    if kind == "mesh":
        packed = pairs.pack_bvh(scene.bvh, scene.triangles, form=form)
        assert packed.max_leaf > pairs.TRIS_PER_ROW
        o, d = _rays(512, seed=13)
    elif kind == "twins":
        packed = twin_scene(form)
        o, d = _rays(512, seed=14)
    else:
        packed = deep_tree_scene(pairs.TRAVERSAL_STACK).packed
        rng = np.random.default_rng(12)
        n = 256
        o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)),
                            np.ones((n, 1))], 1)
        d = np.concatenate([rng.uniform(-0.01, 0.01, (n, 2)),
                            -np.ones((n, 1))], 1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    want = bk.intersect_packed_plain(packed, o, d, with_slot=True)
    assert int((want[0] < 1e19).sum()) > 0
    if kind == "twins":  # both copies win somewhere
        assert set(want[2][want[0] < 1e19].tolist()) == {0, 1}
    _assert_same(host_walk(7 if form == "bw" else 8, packed, o, d), want)


def blocks_twice(tables):
    """``tables`` followed by a copy of all its blocks, the copies'
    material ids raised by 8: every triangle in two blocks, a tie the
    earlier block wins."""
    pay = tables.coeff_pay.clone().view(-1, mxu.BLOCK_ROWS, mxu.SUPERLEAF)
    pay[:, 3] = torch.where(pay[:, 3] != 0, pay[:, 3] + 8, 0.0)
    return dataclasses.replace(
        tables, coeff_uv=torch.cat([tables.coeff_uv, tables.coeff_uv]),
        coeff_t=torch.cat([tables.coeff_t, tables.coeff_t]),
        coeff_pay=torch.cat([tables.coeff_pay, pay.view(-1, mxu.SUPERLEAF)]))


def _lane_trees(scene):
    """Superleaf packings whose blocks are partly filled: the mesh at
    superleaf 128 (88 of 128 lanes a block) and 32 (cut nodes of at most
    32 triangles bin-packed); twinned triangles, whose every hit ties two
    lanes of one block; the mesh's blocks twice (:func:`blocks_twice`),
    ties across two blocks."""
    twins = twin_mesh_scene()
    tables = mxu.pack_bvh_mxu(scene.bvh, scene.triangles)
    return {
        "mesh": tables,
        "mesh_32": mxu.pack_bvh_mxu(scene.bvh, scene.triangles, 32),
        "twins": mxu.pack_bvh_mxu(twins.bvh, twins.triangles),
        "blocks_twice": blocks_twice(tables),
    }


@pytest.mark.parametrize("rays", [1, 2, 4])
@pytest.mark.parametrize("tree", ["mesh", "mesh_32", "twins",
                                  "blocks_twice"])
def test_host_lane_stream_matches_plain(host_walk, scene, tree, rays):
    """The lane-record stream with 1, 2 or 4 rays a thread (#8 holds
    several, #7 one) against ``intersect_mxu_plain``: t, normal, material
    id and winner slot bit for bit, on a ray count that is not a multiple
    of the rays a thread; on the twins both copies win somewhere, and of
    blocks twice only the first: the lowest lane and the earlier block
    decide ties as the plain version does."""
    tables = _lane_trees(scene)[tree]
    lanes = tables.lanes
    counts = lanes.offsets[1:] - lanes.offsets[:-1]
    assert (counts < mxu.SUPERLEAF).any()  # partly filled blocks
    o, d = _rays(509, seed=21)
    t, n, mid, slot = mk.stream_blocks(tables, o, d, torch.full((509,), 1e20))
    assert 100 < int((t < 1e19).sum()) < 509
    if tree == "twins":
        assert set(mid[t < 1e19].tolist()) == {0.0, 1.0}
    if tree == "blocks_twice":
        assert (slot < (lanes.offsets.numel() - 1) // 2 * mxu.SUPERLEAF).all()
    _assert_same(host_walk(0, tables, o, d, rays=rays),
                 (t, n, mid.to(torch.int32), slot))


def test_host_zero_lanes_never_hit(host_walk, scene):
    """A lane whose coefficients are all zero never hits: a block of 128
    zero lanes (forced real) misses every ray, inf and NaN rays included;
    and a triangle zeroed inside a block (so its lane stays real) wins no
    ray, while the stream still equals the plain version."""
    o, d = _rays(256, seed=22)
    o[:8] = torch.tensor([float("inf"), float("nan"), 1e30])
    d[8:16] = torch.tensor([0.0, 0.0, 0.0])
    zero = mxu.LaneRecords(records=torch.zeros((mxu.SUPERLEAF,
                                                mxu.LANE_RECORD)),
                           offsets=torch.tensor([0, mxu.SUPERLEAF],
                                                dtype=torch.int32),
                           n_lanes=mxu.SUPERLEAF, max_lanes=mxu.SUPERLEAF)
    one = mxu.pack_bvh_mxu(scene.bvh, scene.triangles)
    one = dataclasses.replace(one, coeff_uv=one.coeff_uv[:8],
                              coeff_t=one.coeff_t[:8],
                              coeff_pay=one.coeff_pay[:8])
    for rays in (1, 4):
        t, n, mid, slot = host_walk(0, one, o, d, rays=rays, lanes=zero)
        assert (t == 1e20).all() and (slot == -1).all() and (mid == -1).all()
    tables = mxu.pack_bvh_mxu(scene.bvh, scene.triangles)
    o, d = _rays(512, seed=23)
    _, _, _, slot = mk.stream_blocks(tables, o, d, torch.full((512,), 1e20))
    lane = int(torch.mode(slot[slot >= 0]).values)  # the most hit lane
    b, j = divmod(lane, mxu.SUPERLEAF)
    uv, tc = tables.coeff_uv.clone(), tables.coeff_t.clone()
    uv[8 * b: 8 * b + 8, j::mxu.SUPERLEAF] = 0.0
    tc[8 * b: 8 * b + 8, j] = 0.0
    cut = dataclasses.replace(tables, coeff_uv=uv, coeff_t=tc)
    assert torch.equal(cut.lanes.offsets, tables.lanes.offsets)
    want = mk.stream_blocks(cut, o, d, torch.full((512,), 1e20))
    assert not (want[3] == lane).any()
    got = host_walk(0, cut, o, d, rays=2)
    _assert_same(got, (want[0], want[1], want[2].to(torch.int32), want[3]))
