"""The superleaf kernels' device code (``csrc/superleaf.cuh`` over
``bvh.cuh`` and ``trace.cuh``) built as plain host C++ and run ray by ray
on the CPU, against the plain versions: the lane-record stream of kernels
#7 and #8 (``stream_records`` over each block's real lanes, R rays a
thread as #8 holds them) against ``intersect_mxu_plain``, and the pair
walk with superleaf blocks (#2b) or leaf rows (#2, #3) against
``intersect_packed_plain``, on the mesh scene and on a tree as deep as the
walk's stack allows, through a stack accessor that records how deep the
walk stacks; and kernel #2b's warp-wide walk (``walk_blocks_warp``) on 32
host threads a warp that post each warp primitive's values and meet at a
barrier (``HostWarp``), with and without its lane groups pruned by their
boxes (``accel/mxu.py:lane_group_bounds``, held here against the scene's
triangles).

The headers use no intrinsics but ``__ldg``, ``__ffs``, ``__popc`` and
the float/bit casts outside the device-only warp primitives, so with
``__device__`` and ``__forceinline__`` defined away and those stubbed a
host compiler builds them; built with ``-ffp-contract=off`` as the kernels are
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
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
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
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
#include "superleaf.cuh"
using namespace spira;

// in: int32 mode n_rays n_pairs n_blocks root rays n_lanes; float32
// origins (n, 3), dirs (n, 3), pairs (P, 16), then modes 0 and 1:
// coeff_pay (B*8, 128), the lane records (L, 24) and int32 offsets (B + 1);
// modes 2-8: tri_rows (B, 128).  Modes:
// 0 the lane-record stream (`rays` rays a thread: 1, 2 or 4), 1 the pair
// walk over blocks (RecordLeaves, one thread a visit; `rays` records
// loaded at a time), 2 and 3 over BW and MT rows, 4 and 5 the same walks
// counting (WalkCounts, bounce 0), 6 the BW walk over HostStack, 7 and 8
// the BW and MT walks loading leaf triangles 4 at a time (kernel #3's
// RowLeaves<kForm, 4>), 9 kernel #2b's warp-wide walk over blocks
// (walk_blocks_warp, `rays` records a thread loaded at a time), 32 threads
// of HostWarp a warp, ray i without a ray (live false) where i % 7 == 3;
// it counts (WalkCounts); 10 the same pruning groups by their boxes (then
// float32 group boxes (B*8*2, 4) follow the offsets).
// out: float32 t, normal (n, 3), mat id; int32 slot; modes 4-5 and 9:
// int32 pops, pushes, traversals, leaf_visits, leaf_tris,
// leaf_visits_primary (6, n); mode 6: int32 the deepest stack (n).

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
// A warp of 32 host threads: each primitive posts the thread's value,
// waits for the other 31, reads, and waits again before the slots are
// reused.
struct WarpSlots {
  std::barrier<> bar{kWarp};
  unsigned u[kWarp];
  float f[kWarp];
  int i[kWarp];
};
struct HostWarp {
  WarpSlots* w;
  int id;
  int lane() const { return id; }
  unsigned ballot(bool p) const {
    w->u[id] = p;
    w->bar.arrive_and_wait();
    unsigned m = 0;
    for (int k = 0; k < kWarp; ++k) m |= (w->u[k] ? 1u : 0u) << k;
    w->bar.arrive_and_wait();
    return m;
  }
  bool any(bool p) const { return ballot(p) != 0; }
  float shfl(float v, int src) const {
    w->f[id] = v;
    w->bar.arrive_and_wait();
    const float r = w->f[src];
    w->bar.arrive_and_wait();
    return r;
  }
  int shfl(int v, int src) const {
    w->i[id] = v;
    w->bar.arrive_and_wait();
    const int r = w->i[src];
    w->bar.arrive_and_wait();
    return r;
  }
  unsigned min(unsigned v) const {
    w->u[id] = v;
    w->bar.arrive_and_wait();
    unsigned m = w->u[0];
    for (int k = 1; k < kWarp; ++k) m = w->u[k] < m ? w->u[k] : m;
    w->bar.arrive_and_wait();
    return m;
  }
};
// Kernel #2b's warp-wide walk of rays 0 .. n - 1, 32 threads a warp, each
// its own ray; th and c take each ray's result and counts.
template <int kBatch, bool kPrune = false>
void warp_walks(const float4* p4, const RecordLeaves<>& leaves, int root,
                const float* rays, int n, TriHit* th, WalkCounts* c) {
  for (int w0 = 0; w0 < n; w0 += kWarp) {
    WarpSlots slots;
    std::vector<std::thread> warp;
    for (int l = 0; l < kWarp; ++l) {
      warp.emplace_back([&, l] {
        const int i = w0 + l;
        const bool live = i < n && i % 7 != 3;
        Vec3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
        if (i < n) {
          const float* r = rays + 3 * i;
          o = {r[0], r[1], r[2]};
          d = {r[3 * n], r[3 * n + 1], r[3 * n + 2]};
        }
        TriHit h{kInf, {0.0f, 0.0f, 0.0f}, -1.0f, -1};
        WalkCounts counts;
        HostStack stack;
        walk_blocks_warp<kBatch, kPrune>(p4, leaves, root, o, d, live, h,
                                         counts, stack, HostWarp{&slots, l});
        if (i < n) {
          th[i] = h;
          c[i] = counts;
        }
      });
    }
    for (auto& t : warp) t.join();
  }
}
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
  const bool blocks = mode < 2 || mode == 9 || mode == 10;
  const size_t n_tab =
      blocks ? static_cast<size_t>(nb) * 8 * 128 + n_lanes * 24
             : static_cast<size_t>(nb) * 128;
  std::vector<float> rays(6 * n), pr(16 * n_pairs), tab(n_tab);
  std::vector<int> off(blocks ? nb + 1 : 0);
  std::vector<float> groups(mode == 10 ? static_cast<size_t>(nb) * 64 : 0);
  if (fread(rays.data(), 4, rays.size(), f) != rays.size() ||
      fread(pr.data(), 4, pr.size(), f) != pr.size() ||
      fread(tab.data(), 4, tab.size(), f) != tab.size() ||
      fread(off.data(), 4, off.size(), f) != off.size() ||
      fread(groups.data(), 4, groups.size(), f) != groups.size()) return 1;
  fclose(f);
  const float* cpay = tab.data();
  const auto* rec = reinterpret_cast<const float4*>(
      cpay + static_cast<size_t>(nb) * 8 * 128);
  const auto* p4 = reinterpret_cast<const float4*>(pr.data());
  const auto* s4 = reinterpret_cast<const float4*>(tab.data());
  std::vector<float> out(5 * n);
  std::vector<int> slot(n), counts(6 * n);
  std::vector<TriHit> streamed(n);
  std::vector<WalkCounts> warp_counts(n);
  const RecordLeaves<> leaves{
      rec, off.data(), cpay, reinterpret_cast<const float4*>(groups.data())};
  if (mode == 10) warp_walks<1, true>(
      p4, leaves, root, rays.data(), n, streamed.data(), warp_counts.data());
  if (mode == 9 && rays_a_thread == 1) warp_walks<1>(
      p4, leaves, root, rays.data(), n, streamed.data(), warp_counts.data());
  if (mode == 9 && rays_a_thread == 2) warp_walks<2>(
      p4, leaves, root, rays.data(), n, streamed.data(), warp_counts.data());
  if (mode == 9 && rays_a_thread == 4) warp_walks<4>(
      p4, leaves, root, rays.data(), n, streamed.data(), warp_counts.data());
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
    if (mode == 0 || mode == 9 || mode == 10) th = streamed[i];
    if (mode == 1 && rays_a_thread == 1) walk_packed(p4, leaves, root, o, d,
                                                     th);
    if (mode == 1 && rays_a_thread == 2) {
      walk_packed(p4, RecordLeaves<2>{rec, off.data(), cpay}, root, o, d, th);
    }
    if (mode == 1 && rays_a_thread == 4) {
      walk_packed(p4, RecordLeaves<4>{rec, off.data(), cpay}, root, o, d, th);
    }
    if (mode == 2) walk_packed(p4, RowLeaves<kFormBW>{s4}, root, o, d, th);
    if (mode == 3) walk_packed(p4, RowLeaves<kFormMT>{s4}, root, o, d, th);
    WalkCounts c = warp_counts[i];
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
  if (mode == 4 || mode == 5 || mode == 9 || mode == 10) {
    fwrite(counts.data(), 4, counts.size(), g);
  }
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
    subprocess.run([cxx, "-O2", "-std=c++20", "-pthread",
                    "-ffp-contract=off", f"-I{_build.CSRC}",
                    str(work / "driver.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)

    def run(mode, tree, origins, dirs, rays=1, lanes=None):
        n = origins.shape[0]
        blocks = mode in (0, 1, 9, 10)
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
            if mode == 10:
                tree.groups.numpy().astype(np.float32).tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                       check=True)
        raw = np.fromfile(work / "out.bin", np.float32, count=5 * n)
        slot = np.fromfile(work / "out.bin", np.int32, offset=20 * n,
                           count=n)
        out = (torch.from_numpy(raw[:n].copy()),
               torch.from_numpy(raw[n:4 * n].reshape(n, 3).copy()),
               torch.from_numpy(raw[4 * n:].astype(np.int32)),
               torch.from_numpy(slot.copy()))
        if mode in (0, 1, 2, 3, 7, 8):
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


# ---------------------------------------------------------------------------
# Kernel #2b's warp-wide walk (superleaf.cuh:walk_blocks_warp)
# ---------------------------------------------------------------------------

def one_block_scene(n_tris, device="cpu"):
    """A scene of ``n_tris`` (1..128) triangles of a wavy grid around the
    origin, the nearest to (0, 0.1) first, in materials 0 and 1, its
    superleaf tree on ``wide``: one cut, so one block whose real lanes are
    the ``n_tris`` triangles."""
    k = 8
    x, y = np.meshgrid(np.linspace(-1.15, 1.25, k + 1),
                       np.linspace(-0.95, 1.25, k + 1))
    z = 0.3 * np.sin(2.0 * x) * np.cos(2.0 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    quads = [(r * (k + 1) + c, r * (k + 1) + c + 1, (r + 1) * (k + 1) + c,
              (r + 1) * (k + 1) + c + 1) for r in range(k) for c in range(k)]
    faces = np.array([f for a, b, c, d in quads
                      for f in ((a, b, d), (a, d, c))])
    mid = verts[faces].mean(axis=1)[:, :2] - np.array([0.0, 0.1])
    faces = faces[np.argsort((mid ** 2).sum(axis=1), kind="stable")][:n_tris]
    tris = sp.make_triangles(verts, faces, np.arange(n_tris) % 2,
                             device="cpu")
    scene = sp.make_scene(triangles=tris, materials=tie_materials(),
                          bvh=bvh.build_bvh_for_triangles(tris))
    scene = mxu.attach_superleaf(scene)
    assert scene.wide.n_blocks == 1
    assert scene.wide.lanes.n_lanes == n_tris
    return scene.to(device)


def tie_materials(device="cpu"):
    """16 materials: room for :func:`blocks_twice`'s raised ids."""
    return sp.make_materials(
        [dict(albedo=(0.2 + 0.05 * k, 0.5, 0.8 - 0.05 * k))
         for k in range(16)], device=device)


def twin_block_scene(device="cpu"):
    """:func:`twin_mesh_scene` on its superleaf tree: every triangle twice
    in adjacent lanes of one block, every hit a tie the lower lane wins."""
    scene = mxu.attach_superleaf(dataclasses.replace(
        twin_mesh_scene(), materials=tie_materials()))
    return scene.to(device)


def chain_twice_scene(swap=False, device="cpu"):
    """:func:`one_block_scene` of 80 triangles whose block is there twice
    (:func:`blocks_twice`: the copy's material ids raised by 8), the root
    pair record holding both under the same box: one leaf chain through two
    blocks whose every hit is a tie.  Equal entry distances put slot 0
    first, so slot 0's block wins every tie: block 0, or with ``swap`` the
    copy (block 1)."""
    scene = one_block_scene(80)
    tree = scene.wide
    pairs_ = tree.pairs.clone()
    root = pairs_[tree.root]
    assert float(root[15]) == -1.0  # the second slot is empty
    root[8:16] = root[0:8]
    root[6], root[14] = (1.0, 0.0) if swap else (0.0, 1.0)
    twice = dataclasses.replace(blocks_twice(tree), pairs=pairs_, n_blocks=2)
    return dataclasses.replace(scene, wide=twice).to(device)


WARP_TREES = ("mesh", "mesh_32", "twins", "chain", "chain_swapped",
              "one_lane", "full_block")


def _warp_tree(name, scene):
    if name.startswith("mesh"):
        return mxu.pack_bvh_superleaf(scene.bvh, scene.triangles,
                                      32 if name == "mesh_32" else 128)
    if name == "twins":
        return twin_block_scene().wide
    if name.startswith("chain"):
        return chain_twice_scene(swap=name == "chain_swapped").wide
    return one_block_scene(1 if name == "one_lane" else 128).wide


def _plain_walk_totals(tree, o, d):
    """The plain walk's hits and its totals: records popped, blocks
    visited and their real lanes (the kernel tests those)."""
    real = tree.lanes.offsets.diff()
    work = dict(pops=0, blocks=0, lanes=0)
    slab, block_hits = bk._slab, bk._block_hits

    def counting_slab(rec, half, *args):
        if half == 0:
            work["pops"] += rec.shape[0]
        return slab(rec, half, *args)

    def counting_block_hits(views, ptr, *args):
        work["blocks"] += ptr.numel()
        work["lanes"] += int(real[ptr].sum())
        return block_hits(views, ptr, *args)

    bk._slab, bk._block_hits = counting_slab, counting_block_hits
    try:
        want = bk.intersect_packed_plain(tree, o, d, with_slot=True)
    finally:
        bk._slab, bk._block_hits = slab, block_hits
    return want, work


@pytest.mark.parametrize("tree", WARP_TREES)
def test_host_warp_walk_matches_plain(host_walk, scene, tree):
    """#2b's warp-wide walk (``walk_blocks_warp`` on 32 host threads a
    warp, every seventh thread without a ray of its own) against the plain
    walk: t, normal, material id and winner slot bit for bit on each ray,
    a miss without a ray; ties within a block (twins: the lower lane),
    across the two blocks of one leaf chain (the earlier visited: block 0,
    swapped block 1), a block of one real lane and one of 128; and the
    walk's counts: records popped, blocks visited and their real lanes
    the plain walk's."""
    t_ = _warp_tree(tree, scene)
    o, d = _rays(509, seed=31)
    (t, n, mid, slot), work = _plain_walk_totals(t_, o, d)
    assert int((t < 1e19).sum()) > 20
    if tree == "twins":  # both copies win somewhere: lane order decides
        assert set(mid[t < 1e19].tolist()) == {0.0, 1.0}
    if tree.startswith("chain"):
        first = 1 if tree == "chain_swapped" else 0
        assert (slot[t < 1e19] // mxu.SUPERLEAF == first).all()
    dead = torch.arange(509) % 7 == 3
    t, n, mid, slot = t.clone(), n.clone(), mid.clone(), slot.clone()
    t[dead], n[dead], mid[dead], slot[dead] = 1e20, 0.0, -1.0, -1
    got, counts = host_walk(9, t_, o, d)
    _assert_same(got, (t, n, mid.to(torch.int32), slot))
    live = ~dead
    dead_work = _plain_walk_totals(t_, o[dead], d[dead])[1]
    assert int(counts[2][dead].sum()) == 0  # no walk without a ray
    assert int(counts[0].sum()) == work["pops"] - dead_work["pops"]
    assert int(counts[3].sum()) == work["blocks"] - dead_work["blocks"]
    assert int(counts[4].sum()) == work["lanes"] - dead_work["lanes"]
    assert int(counts[2][live].min()) == 1


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("walk", ["warp", "serial"])
def test_host_block_visit_batches_match_plain(host_walk, scene, walk, batch):
    """#2b's variants that load 2 or 4 lane records before testing any,
    the warp-wide walk and the serial one (``RecordLeaves<kBatch>``): the
    plain walk's hits to the bit on the mesh and on twinned triangles."""
    for tree in ("mesh", "twins"):
        t_ = _warp_tree(tree, scene)
        o, d = _rays(300, seed=32)
        want = bk.intersect_packed_plain(t_, o, d, with_slot=True)
        if walk == "warp":
            dead = torch.arange(300) % 7 == 3
            want = tuple(x.clone() for x in want)
            for x, v in zip(want, (1e20, 0.0, -1.0, -1)):
                x[dead] = v
            got = host_walk(9, t_, o, d, rays=batch)[0]
        else:
            got = host_walk(1, t_, o, d, rays=batch)
        _assert_same(got, (want[0], want[1], want[2].to(torch.int32),
                           want[3]))


# ---------------------------------------------------------------------------
# The group boxes of #2b's pruning variant (accel/mxu.py:lane_group_bounds)
# ---------------------------------------------------------------------------

def _pruned_walk(tree, o, d):
    """The plain walk with each block visit through
    ``block_hits_pruned``: its hits and the real lanes of the groups it
    entered, over all visits."""
    real = tree.lanes.offsets.diff().long()
    lanes = [0]

    def pruned(views, ptr, o_, d_, best):
        out = bk.block_hits_pruned(views, tree.groups, ptr, o_, d_, best)
        enter = out[5].repeat_interleave(mxu.LANE_GROUP, 1)
        inside = torch.arange(mxu.SUPERLEAF)[None] < real[ptr][:, None]
        lanes[0] += int((enter & inside).sum())
        return out[:5]

    block_hits = bk._block_hits
    bk._block_hits = pruned
    try:
        got = bk.intersect_packed_plain(tree, o, d, with_slot=True)
    finally:
        bk._block_hits = block_hits
    return got, lanes[0]


@pytest.mark.parametrize("tree", ["mesh", "mesh_32", "twins", "full_block"])
def test_group_bounds_contain_lane_triangles(scene, tree):
    """Each group box holds the triangles of its real lanes, as the scene
    has them (v0, v0 + e1, v0 + e2 of the triangle whose edges the lane's
    coefficients store, the nearest of those with the same edges): the
    lanes' vertices recovered from the coefficients are the scene's within
    1e-5, and a group without a real lane is marked empty (count -1)."""
    t_ = _warp_tree(tree, scene)
    src = (twin_mesh_scene().triangles if tree == "twins" else
           one_block_scene(128).triangles if tree == "full_block"
           else scene.triangles)
    uv = t_.coeff_uv.view(-1, mxu.BLOCK_ROWS, 3, mxu.SUPERLEAF)
    real = t_.lanes.offsets.diff().long()
    key = {}  # (e1, e2) -> the triangles with those edges
    for k, e in enumerate(zip(src.e1.tolist(), src.e2.tolist())):
        key.setdefault(tuple(map(tuple, e)), []).append(k)
    verts, ok = mxu.lane_vertices(t_.coeff_uv, t_.coeff_t)
    boxes = t_.groups.view(-1, mxu.GROUPS, 2, 4)
    lo, hi = boxes[:, :, 0, 0:3], torch.cat([boxes[:, :, 0, 3:4],
                                             boxes[:, :, 1, 0:2]], -1)
    checked = 0
    for b in range(real.numel()):
        for j in range(int(real[b])):
            e2 = tuple(uv[b, 0:3, 1, j].tolist())
            e1 = tuple((-uv[b, 0:3, 2, j]).tolist())
            k = min(key[(e1, e2)], key=lambda k: float(
                (src.v0[k].double() - verts[b, j, 0]).abs().max()))
            v0 = src.v0[k].double()
            tri = torch.stack([v0, v0 + src.e1[k].double(),
                               v0 + src.e2[k].double()])
            assert ok[b, j]
            assert torch.allclose(verts[b, j], tri, atol=1e-5, rtol=0)
            g = j // mxu.LANE_GROUP
            assert (tri >= lo[b, g].double()).all()
            assert (tri <= hi[b, g].double()).all()
            checked += 1
        for g in range(mxu.GROUPS):
            used = g * mxu.LANE_GROUP < int(real[b])
            assert float(boxes[b, g, 1, 3]) == (1.0 if used else -1.0)
    assert checked == t_.lanes.n_lanes


@pytest.mark.parametrize("tree", ["mesh", "mesh_32", "twins", "chain",
                                  "full_block"])
def test_pruned_visits_match_block_hits(host_walk, scene, tree):
    """A block visit that skips the groups whose box the ray does not
    enter before its best (``block_hits_pruned``, and #2b's pruning
    variant of the warp-wide walk on host threads) gives ``_block_hits``'
    hits, t and slot for slot: per visit on random rays, blocks and bests,
    and over whole walks, where it tests fewer lanes than the visit of
    every lane; the variant's count of lanes tested is the plain pruned
    walk's."""
    t_ = _warp_tree(tree, scene)
    views = bk.block_views(t_)
    rng = np.random.default_rng(33)
    o, d = _rays(2048, seed=34)
    ptr = torch.from_numpy(rng.integers(0, t_.n_blocks, 2048))
    best = torch.from_numpy(rng.uniform(0.5, 4.0, 2048).astype(np.float32))
    best[::3] = 1e20
    want = bk._block_hits(views, ptr, o, d, best)
    got = bk.block_hits_pruned(views, t_.groups, ptr, o, d, best)
    assert int(want[0].sum()) > 50
    for a, b in zip(got[:5], want):
        assert torch.equal(a, b)
    assert got[5].float().mean() < 0.9  # groups were skipped
    o, d = _rays(509, seed=35)
    (t, n, mid, slot), work = _plain_walk_totals(t_, o, d)
    pruned, lanes = _pruned_walk(t_, o, d)
    _assert_same(pruned, (t, n, mid, slot))
    assert lanes < work["lanes"]
    dead = torch.arange(509) % 7 == 3
    for x, v in zip((t, n, mid, slot), (1e20, 0.0, -1.0, -1)):
        x[dead] = v
    got, counts = host_walk(10, t_, o, d)
    _assert_same(got, (t, n, mid.to(torch.int32), slot))
    dead_lanes = _pruned_walk(t_, o[dead], d[dead])[1]
    assert int(counts[4].sum()) == lanes - dead_lanes
