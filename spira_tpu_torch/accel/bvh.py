"""Flat BVH construction (host side).

Counterpart of :mod:`spira_tpu.accel.bvh`: largest-centroid-extent axis,
median split, flat node array and leaf-contiguous primitive permutation,
built in NumPy; ``build_two_level`` stitches per-mesh trees under a top tree
over mesh bounds so traversal stays one walk.  The per-mesh trees come from
the shared C++ binned-SAH builder when it is available
(:mod:`spira_tpu_torch.accel.native`).

Layout (node i):
  * internal: ``left[i]``/``right[i]`` are child node indices,
    ``is_leaf[i] == 0``; a two-level redirect node has ``left == right``.
  * leaf: ``left[i]`` is the first index into ``prim_idx``, ``right[i]`` the
    primitive count, ``is_leaf[i] == 1``.

The tables are CPU tensors; :class:`FlatBVH` moves with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import tensor_dataclass
from ..scene.geometry import concat_triangles, triangle_bounds

LEAF_SIZE = 4
MAX_STACK = 64  # the builders force a leaf at depth MAX_STACK - 2


@tensor_dataclass
class FlatBVH:
    """Flat BVH tables: node boxes, links, and the primitive permutation."""

    node_min: torch.Tensor  # (M, 3) float32
    node_max: torch.Tensor  # (M, 3) float32
    left: torch.Tensor  # (M,) int32 — child index | first-prim offset
    right: torch.Tensor  # (M,) int32 — child index | prim count
    is_leaf: torch.Tensor  # (M,) int32 0/1
    prim_idx: torch.Tensor  # (T,) int32 permutation into the triangle SoA
    # Stackless-traversal links (filled by add_links): parent node (-1 at
    # the root), sibling (-1 = none, e.g. under a two-level redirect), and
    # whether this node is its parent's left child.
    parent: torch.Tensor = None  # (M,) int32
    sibling: torch.Tensor = None  # (M,) int32
    is_left: torch.Tensor = None  # (M,) int32 0/1
    max_leaf: int = LEAF_SIZE  # largest leaf count
    # mixed sphere+triangle trees (build_mixed_bvh): prim ids < n_sph are
    # spheres, ids >= n_sph triangle id - n_sph
    n_sph: int = 0

    @property
    def node_count(self) -> int:
        return self.node_min.shape[0]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _flat(node_min, node_max, left, right, is_leaf, prim_idx) -> FlatBVH:
    left, right, is_leaf = (np.asarray(a) for a in (left, right, is_leaf))
    return add_links(FlatBVH(
        node_min=_f32(node_min), node_max=_f32(node_max), left=_i32(left),
        right=_i32(right), is_leaf=_i32(is_leaf), prim_idx=_i32(prim_idx),
        max_leaf=int(right[is_leaf == 1].max()),
    ))


def add_links(bvh: FlatBVH) -> FlatBVH:
    """Compute parent/sibling/is_left arrays for stackless traversal."""
    left = bvh.left.numpy()
    right = bvh.right.numpy()
    is_leaf = bvh.is_leaf.numpy()
    m = left.shape[0]
    parent = np.full(m, -1, np.int32)
    sibling = np.full(m, -1, np.int32)
    is_left_arr = np.zeros(m, np.int32)
    internal = np.nonzero(is_leaf == 0)[0].astype(np.int32)
    l, r = left[internal], right[internal]
    parent[l] = internal
    is_left_arr[l] = 1
    # redirect nodes (two-level stitch) have a single child (l == r) whose
    # sibling stays -1
    two = internal[l != r]
    parent[right[two]] = two
    sibling[left[two]] = right[two]
    sibling[right[two]] = left[two]
    return dataclasses.replace(bvh, parent=_i32(parent),
                               sibling=_i32(sibling), is_left=_i32(is_left_arr))


def build_bvh(lo: np.ndarray, hi: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build a flat BVH over primitives with AABBs [lo, hi], both (T, 3)."""
    arrays, order = _build_arrays(lo, hi, leaf_size)
    return _flat(*arrays, order)


def _build_arrays(lo, hi, leaf_size):
    """Median-split build; returns ((node_min, node_max, left, right,
    is_leaf) as lists, the primitive order)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    centroids = 0.5 * (lo + hi)
    order = np.arange(n)
    node_min, node_max, left, right, is_leaf = [], [], [], [], []

    def alloc():
        for a, v in ((node_min, None), (node_max, None), (left, 0),
                     (right, 0), (is_leaf, 0)):
            a.append(v)
        return len(left) - 1

    # iterative build over (node_index, start, end, depth)
    stack = [(alloc(), 0, n, 0)]
    while stack:
        node, start, end, depth = stack.pop()
        idxs = order[start:end]
        node_min[node] = lo[idxs].min(axis=0)
        node_max[node] = hi[idxs].max(axis=0)
        count = end - start
        # a leaf at count <= leaf_size, or when too deep for the stack
        if count <= leaf_size or depth >= MAX_STACK - 2:
            left[node], right[node], is_leaf[node] = start, count, 1
            continue
        c = centroids[idxs]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = count // 2
        part = np.argpartition(c[:, axis], mid)  # O(n) median split
        order[start:end] = idxs[part]
        l, r = alloc(), alloc()
        left[node], right[node], is_leaf[node] = l, r, 0
        stack.append((l, start, start + mid, depth + 1))
        stack.append((r, start + mid, end, depth + 1))
    return (node_min, node_max, left, right, is_leaf), order


def build_mixed_bvh(spheres, tris=None, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """One tree over spheres and triangles (mixed-primitive leaves),
    median split: sphere s is primitive s with the box center ± radius,
    triangle t is primitive ``n_sph + t``.  Traverse it with
    :func:`spira_tpu_torch.accel.traverse.intersect_bvh_mixed`
    (:func:`spira_tpu_torch.integrator.intersect.intersect_scene` does for
    a scene whose ``bvh.n_sph > 0``)."""
    centers = spheres.centers.detach().cpu().numpy().astype(np.float64)
    radii = spheres.radii.detach().cpu().numpy().astype(np.float64)[:, None]
    lo, hi = [centers - radii], [centers + radii]
    if tris is not None and tris.count > 0:
        tlo, thi = triangle_bounds(tris)
        lo.append(tlo)
        hi.append(thi)
    arrays, order = _build_arrays(np.concatenate(lo), np.concatenate(hi),
                                  leaf_size)
    return dataclasses.replace(_flat(*arrays, order),
                               n_sph=int(spheres.count))


def _build_one(lo, hi, leaf_size, use_native, row_size):
    """One mesh's tree: the native builder when asked and available (with
    the NumPy builder as its fallback), else the NumPy builder."""
    if use_native:
        from .native import build_bvh_best

        return build_bvh_best(lo, hi, leaf_size, row_size=row_size)
    return build_bvh(lo, hi, leaf_size)


def build_bvh_for_triangles(tris, leaf_size: int = LEAF_SIZE,
                            use_native: bool = True,
                            row_size: int = 8) -> FlatBVH:
    """Build over a triangle soup.  ``row_size=8`` (default) prices the
    native builder's SAH in 8-triangle leaf rows, the unit the packed
    tables store leaves in; 0 restores the per-primitive SAH."""
    lo, hi = triangle_bounds(tris)
    return _build_one(lo, hi, leaf_size, use_native, row_size)


def build_two_level(mesh_triangle_list, leaf_size: int = LEAF_SIZE,
                    use_native: bool = True, row_size: int = 8):
    """Build per-mesh BVHs plus a top-level tree over mesh bounds and stitch
    them into one flat array.

    Returns (FlatBVH, Triangles): node and primitive indices are rebased so
    the result traverses like a single-level tree, with the concatenated
    triangle soup to index with it.
    """
    mesh_lo, mesh_hi = [], []
    for tris in mesh_triangle_list:
        lo, hi = triangle_bounds(tris)
        mesh_lo.append(lo.min(axis=0))
        mesh_hi.append(hi.max(axis=0))
    top, top_order = _build_arrays(np.asarray(mesh_lo), np.asarray(mesh_hi),
                                   leaf_size=1)

    # top-tree leaves (each holding exactly one mesh) become redirections
    # to that mesh's rebased root node
    n_top = len(top[2])
    parts = [[np.asarray(a) for a in top]]
    node_base = n_top
    prim_base = 0
    mesh_root = {}
    prim_idx_parts = []
    for m, tris in enumerate(mesh_triangle_list):
        lo, hi = triangle_bounds(tris)
        sub = _build_one(lo, hi, leaf_size, use_native, row_size)
        a_leaf = sub.is_leaf.numpy()
        # rebase child indices / prim offsets
        a_left = np.where(a_leaf == 1, sub.left.numpy() + prim_base,
                          sub.left.numpy() + node_base)
        a_right = np.where(a_leaf == 1, sub.right.numpy(),
                           sub.right.numpy() + node_base)
        parts.append([sub.node_min.numpy(), sub.node_max.numpy(), a_left,
                      a_right, a_leaf])
        mesh_root[m] = node_base
        prim_idx_parts.append(sub.prim_idx.numpy().astype(np.int64)
                              + prim_base)
        node_base += sub.node_count
        prim_base += sub.prim_idx.shape[0]

    node_min, node_max, left_all, right_all, leaf_all = (
        np.concatenate([p[k] for p in parts]) for k in range(5))
    # a top leaf over mesh m becomes an internal node whose two children
    # are both mesh m's root: traversal treats is_leaf == 0 with
    # left == right as "push one child"
    for i in range(n_top):
        if leaf_all[i] == 1:
            m = int(top_order[left_all[i]])
            left_all[i] = right_all[i] = mesh_root[m]
            leaf_all[i] = 0
    bvh = _flat(node_min, node_max, left_all, right_all, leaf_all,
                np.concatenate(prim_idx_parts))
    return bvh, concat_triangles(list(mesh_triangle_list))


def validate_bvh(bvh: FlatBVH, lo: np.ndarray, hi: np.ndarray) -> None:
    """Structural invariants (host-side debug aid): every primitive appears
    exactly once; leaf boxes contain their primitives; children lie within
    their parents."""
    prim = bvh.prim_idx.numpy()
    assert sorted(prim.tolist()) == list(range(len(prim))), "prim permutation"
    node_min = bvh.node_min.numpy()
    node_max = bvh.node_max.numpy()
    left = bvh.left.numpy()
    right = bvh.right.numpy()
    is_leaf = bvh.is_leaf.numpy()
    eps = 1e-4
    for i in range(bvh.node_count):
        if is_leaf[i]:
            for p in prim[left[i]: left[i] + right[i]]:
                assert (lo[p] >= node_min[i] - eps).all(), (i, p)
                assert (hi[p] <= node_max[i] + eps).all(), (i, p)
        elif left[i] != right[i]:
            for ch in (left[i], right[i]):
                assert (node_min[ch] >= node_min[i] - eps).all(), (i, ch)
                assert (node_max[ch] <= node_max[i] + eps).all(), (i, ch)
