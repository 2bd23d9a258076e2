"""16-wide BVH packing: the node rows the wide and superleaf tables share.

Counterpart of :mod:`spira_tpu.accel.wide`, packing the same tree into the
same values.  The binary :class:`FlatBVH` collapses into 16-ary nodes, one
(1, 128) float32 row per node: 16 child slots x 8 fields
``[min3 | max3 | ptr | cnt]``.

* child slot c occupies lanes ``8c .. 8c+7``;
* ``cnt == 0`` -> internal child, ``ptr`` = wide row of that child;
  ``cnt > 0`` -> leaf, ``ptr`` = first row in ``tri_rows`` (8 triangles a
  row, the layout of :mod:`spira_tpu_torch.accel.pairs`); ``cnt < 0`` ->
  empty slot with an inverted box (the slab test never hits it);
* children are sorted along the axis of largest centroid spread, and that
  axis is kept in slot 0's ptr field: ``stored = ptr*4 + axis`` (exact in
  float32, ptr < 2^20).

:func:`_collapse16` is the collapse that :func:`spira_tpu_torch.accel.mxu.
pack_bvh_mxu` reuses over its superleaf cut.  Packing is host-side NumPy;
the tables stay on the CPU until the caller moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import replace, tensor_dataclass
from .pairs import TRI_STRIDE, TRIS_PER_ROW, _leaf_rows_needed

WIDTH = 16  # children per wide node
SLOT = 8  # fields per child slot


@tensor_dataclass
class WideBVH:
    """16-wide BVH tables (see the module docstring)."""

    nodes: torch.Tensor  # (N, 128) float32
    tri_rows: torch.Tensor  # (R, 128) float32
    root: int = 0
    n_nodes: int = 0
    n_rows: int = 0
    max_leaf: int = TRIS_PER_ROW


def host_tree(bvh, tris):
    """The binary tree and its triangles as host arrays: (node_min,
    node_max, left, right, is_leaf, prim_idx, v0, e1, e2, normal,
    material as float32)."""

    def f32(x):
        return x.detach().cpu().numpy().astype(np.float32)

    def i64(x):
        return x.detach().cpu().numpy().astype(np.int64)

    return (f32(bvh.node_min), f32(bvh.node_max), i64(bvh.left),
            i64(bvh.right), i64(bvh.is_leaf), i64(bvh.prim_idx),
            f32(tris.v0), f32(tris.e1), f32(tris.e2), f32(tris.normal),
            f32(tris.material))


def binary_kids(left, right):
    """``kids(i)``: the binary children of internal node i (one for the
    two-level builder's redirect nodes)."""

    def kids(i: int):
        l, r = int(left[i]), int(right[i])
        return [l] if l == r else [l, r]

    return kids


def pack_bvh16(bvh, tris) -> WideBVH:
    """Collapse a binary FlatBVH + Triangles into 16-wide node rows (host
    tables, on the CPU)."""
    (node_min, node_max, left, right, is_leaf, prim_idx, v0, e1, e2, nrm,
     mat) = host_tree(bvh, tris)

    # ---- leaf triangle rows (same layout as pairs.pack_bvh)
    leaves = np.nonzero(is_leaf == 1)[0]
    total_rows = max(
        int(sum(_leaf_rows_needed(int(right[i])) for i in leaves)), 1
    )
    tri_rows = np.zeros((total_rows, TRIS_PER_ROW * TRI_STRIDE), np.float32)
    leaf_row = {}
    row = 0
    max_leaf = 1
    for i in leaves:
        first, count = int(left[i]), int(right[i])
        leaf_row[int(i)] = row
        prims = prim_idx[first: first + count]
        tri16 = np.zeros((count, TRI_STRIDE), np.float32)
        tri16[:, 0:3] = v0[prims]
        tri16[:, 3:6] = e1[prims]
        tri16[:, 6:9] = e2[prims]
        tri16[:, 9:12] = nrm[prims]
        tri16[:, 12] = mat[prims]
        need = _leaf_rows_needed(count)
        flat = np.zeros((need, TRIS_PER_ROW * TRI_STRIDE), np.float32)
        flat.reshape(need * TRIS_PER_ROW, TRI_STRIDE)[:count] = tri16
        tri_rows[row: row + need] = flat
        row += need
        max_leaf = max(max_leaf, count)

    kids = binary_kids(left, right)
    # subtree leaf counts (iterative post-order; the tree can be deep)
    leafcount = np.zeros(node_min.shape[0], np.int64)
    post = []
    stk = [0]
    while stk:
        i = stk.pop()
        post.append(i)
        if is_leaf[i] == 0:
            stk.extend(kids(i))
    for i in reversed(post):
        if is_leaf[i] == 1:
            leafcount[i] = 1
        else:
            leafcount[i] = sum(leafcount[c] for c in kids(i))

    nodes, n_out = _collapse16(
        node_min, node_max, kids, is_leaf == 1,
        leaf_ptr=lambda i: leaf_row[int(i)],
        leaf_cnt=lambda i: int(right[i]),
        subtree_weight=leafcount,
    )
    padr = (-tri_rows.shape[0]) % 8
    if padr:
        tri_rows = np.concatenate(
            [tri_rows, np.zeros((padr, 128), np.float32)]
        )
    return WideBVH(
        nodes=torch.from_numpy(nodes),
        tri_rows=torch.from_numpy(tri_rows),
        root=0,
        n_nodes=n_out,
        n_rows=total_rows,
        max_leaf=max_leaf,
    )


def _collapse16(
    node_min, node_max, kids, is_cut, leaf_ptr, leaf_cnt, subtree_weight
):
    """Collapse the binary structure above a cut set into 16-wide rows.

    ``is_cut``: bool per binary node, True making it a leaf slot of the
    wide tree (encoded ptr = ``leaf_ptr(i)``, cnt = ``leaf_cnt(i)``);
    ``subtree_weight`` drives the smallest-subtree absorb heuristic.
    Returns ``(nodes (N,128) float32 padded to 8 rows, n_nodes)``.
    """
    rows_out: list[np.ndarray] = []
    wide_of = {}  # binary id -> wide row index

    if bool(is_cut[0]):
        # degenerate: the root is a leaf; emit one wide node wrapping it
        rec = np.zeros(WIDTH * SLOT, np.float32)
        for c in range(WIDTH):
            rec[SLOT * c + 0: SLOT * c + 3] = 1.0
            rec[SLOT * c + 3: SLOT * c + 6] = -1.0
            rec[SLOT * c + 7] = -1.0
        rec[0:3] = node_min[0]
        rec[3:6] = node_max[0]
        rec[6] = float(leaf_ptr(0) * 4)  # axis 0
        rec[7] = float(leaf_cnt(0))
        rows_out.append(rec)

    # FIFO order; wide row indexes are assigned on first reference, so
    # children always land after their parent (breadth-first layout)
    wide_of[0] = 0
    head = 0
    order: list[int] = [] if bool(is_cut[0]) else [0]
    recs: dict[int, np.ndarray] = {}
    while head < len(order):
        b = order[head]
        head += 1
        # grow the child set: repeatedly expand the internal member with the
        # smallest subtree, so tiny subtrees become leaf slots inline and
        # only substantial subtrees get their own wide node
        children = kids(b)
        while len(children) < WIDTH:
            cand = [
                c
                for c in children
                if not is_cut[c]
                and len(children) - 1 + len(kids(c)) <= WIDTH
            ]
            if not cand:
                break
            x = min(cand, key=lambda c: int(subtree_weight[c]))
            children.remove(x)
            children.extend(kids(x))

        # sort along the axis of largest centroid spread, then stable-
        # partition leaf slots first
        cents = 0.5 * (node_min[children] + node_max[children])
        spread = cents.max(axis=0) - cents.min(axis=0)
        axis = int(np.argmax(spread))
        children = [children[k] for k in np.argsort(cents[:, axis])]
        children = [c for c in children if is_cut[c]] + [
            c for c in children if not is_cut[c]
        ]

        rec = np.zeros(WIDTH * SLOT, np.float32)
        for c in range(WIDTH):
            base = SLOT * c
            if c >= len(children):
                rec[base + 0: base + 3] = 1.0  # inverted box: lo > hi
                rec[base + 3: base + 6] = -1.0
                rec[base + 7] = -1.0
                continue
            ch = children[c]
            rec[base + 0: base + 3] = node_min[ch]
            rec[base + 3: base + 6] = node_max[ch]
            if is_cut[ch]:
                rec[base + 6] = float(leaf_ptr(ch))
                rec[base + 7] = float(leaf_cnt(ch))
            else:
                if ch not in wide_of:
                    wide_of[ch] = len(order)
                    order.append(ch)
                rec[base + 6] = float(wide_of[ch])
                rec[base + 7] = 0.0
        # keep the sort axis in slot 0's ptr (ptr*4 + axis)
        rec[6] = rec[6] * 4.0 + float(axis)
        recs[b] = rec

    if recs:
        rows_out = [recs[b] for b in order]

    nodes = np.stack(rows_out) if rows_out else np.zeros((1, 128), np.float32)
    # pad the row count to a multiple of 8 (the JAX tables' layout)
    pad = (-nodes.shape[0]) % 8
    if pad:
        nodes = np.concatenate([nodes, np.zeros((pad, 128), np.float32)])
    return nodes, len(rows_out)


def attach_wide(scene):
    """Pack ``scene.bvh`` into 16-wide rows on the scene's ``wide`` slot
    (on the scene's device)."""
    if scene.bvh is None:
        raise ValueError("attach_wide requires a scene with a built BVH")
    return replace(scene, wide=pack_bvh16(scene.bvh, scene.triangles)
                   .to(scene.device))


def wide_slot(rec, c):
    """Child slot ``c`` of wide row ``rec``: (lo3, hi3, ptr, cnt), the
    sort axis taken out of slot 0's ptr."""
    b = SLOT * c
    ptr, cnt = rec[b + 6], int(rec[b + 7])
    if c == 0:
        ptr = np.floor(ptr / 4.0)
    return rec[b: b + 3], rec[b + 3: b + 6], ptr, cnt


def traverse_wide_numpy(wide: WideBVH, origin, direction, t_min=1e-3):
    """Scalar NumPy oracle over the wide tables (tests only): nearest hit
    (t, normal, mat) for one ray, or (inf, 0, -1)."""
    nodes = wide.nodes.cpu().numpy()
    rows = wide.tri_rows.cpu().numpy()
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [wide.root]
    while stack:
        rec = nodes[stack.pop()]
        for c in range(WIDTH):
            lo, hi, ptr, cnt = wide_slot(rec, c)
            if cnt < 0:
                continue
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tn = np.maximum(np.minimum(t0, t1).max(), 0.0)
            tf = np.minimum(np.maximum(t0, t1).min(), best[0])
            if tn > tf:
                continue
            if cnt == 0:
                stack.append(int(ptr))
                continue
            for j in range(cnt):
                r = int(ptr) + j // TRIS_PER_ROW
                lane = TRI_STRIDE * (j % TRIS_PER_ROW)
                f = rows[r, lane: lane + TRI_STRIDE]
                tv0, te1, te2 = f[0:3], f[3:6], f[6:9]
                pv = np.cross(d, te2)
                det = te1 @ pv
                if abs(det) < 1e-9:
                    continue
                tv = o - tv0
                u = (tv @ pv) / det
                qv = np.cross(tv, te1)
                v = (d @ qv) / det
                t = (te2 @ qv) / det
                if u >= 0 and v >= 0 and u + v <= 1 and t_min < t < best[0]:
                    best = (t, f[9:12].copy(), int(f[12]))
    return best
