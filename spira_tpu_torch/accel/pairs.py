"""Pair-record BVH packing: the tables the BVH kernels traverse.

Counterpart of :mod:`spira_tpu.accel.pairs`, packing the same tree into the
same values:

* ``pairs`` (P, 16) float32 — one row per *internal* FlatBVH node, holding
  BOTH children: ``[min3 | max3 | ptr | count] x 2``.  ``count == 0``: an
  internal child, ``ptr`` its pair row; ``count > 0``: a leaf of ``count``
  triangles starting at row ``ptr`` of ``tri_rows``; ``count < 0``: an
  empty slot.  ptr/count are exact small floats.
* ``tri_rows`` (R, 128) float32 — 8 triangles per row, 16 floats each, a
  leaf owning whole consecutive rows.  Two forms (``PackedBVH.form``):

  - ``"mt"`` — Möller–Trumbore operands
    ``[v0(3) e1(3) e2(3) n(3) mat(1) pad(3)]``;
  - ``"bw"`` — the Baldwin–Weber world→barycentric transform (JCGT 2016)
    ``[n̂(3) n̂·v0(1) A(3) a3(1) B(3) b3(1) mat(1) pad(3)]`` with
    ``u(p) = A·p + a3``, ``v(p) = B·p + b3``.

* ``prim_map`` (R*8,) int32 — slot (row*8 + j) → original triangle, -1 on
  padding.

Packing is host-side NumPy, once per scene.  It refuses a tree the kernels
cannot walk correctly: a leaf with no triangles or a range outside
``prim_idx`` (which the C++ row-SAH sweep can emit when it finds no finite
cost) and a tree deeper than the traversal stack (``TRAVERSAL_STACK``, the
per-thread stack of ``csrc/bvh.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import replace, tensor_dataclass

TRIS_PER_ROW = 8
TRI_STRIDE = 16  # floats per triangle within a packed row
PAIR_WIDTH = 16
#: entries of the per-ray traversal stack (``kStackSize`` in csrc/bvh.cuh).
#: A depth-first walk that pushes both children of each record holds at
#: most one pending sibling per level, so it never needs more entries than
#: the tree has pair records on its longest chain.
TRAVERSAL_STACK = 128

# Child-entry field offsets within a pair record half.
_MIN = 0
_MAX = 3
_PTR = 6
_CNT = 7


@tensor_dataclass
class PackedBVH:
    """Pair-record BVH tables (see the module docstring)."""

    pairs: torch.Tensor  # (P, 16) float32
    tri_rows: torch.Tensor  # (R, 128) float32
    prim_map: torch.Tensor = None  # (R*8,) int32
    root: int = 0  # pair row of the root record
    n_rows: int = 0
    n_pairs: int = 0
    max_leaf: int = TRIS_PER_ROW
    depth: int = 1  # pair records on the longest root->leaf chain
    form: str = "mt"  # leaf operand layout: "mt" | "bw"
    fanout: int = 2  # children per record; only pair records are ported


def _leaf_rows_needed(count: int) -> int:
    return (count + TRIS_PER_ROW - 1) // TRIS_PER_ROW


def build_pair_records(root_node, internal, kids, is_leaf_node, leaf_entry,
                       box):
    """Pair-record construction from a binary tree.

    * ``internal``: node ids that get a pair row, in row order.
    * ``kids(i)``: the 1 or 2 children of internal node ``i`` (1 = the
      two-level builder's redirect node; the second slot becomes empty).
    * ``is_leaf_node(c)`` / ``leaf_entry(c) -> (ptr, count)``: what makes a
      child a leaf and where its triangles live.
    * ``box(c) -> (min3, max3)``.

    Returns ``(pairs, root_row, depth)`` with ``depth`` the longest
    root->leaf chain in pair records.  A leaf root is wrapped in a pseudo
    pair record.
    """
    pair_of = {int(i): k for k, i in enumerate(internal)}
    root_is_leaf = bool(is_leaf_node(root_node))
    total_pairs = max(len(internal) + (1 if root_is_leaf else 0), 1)
    pairs = np.zeros((total_pairs, PAIR_WIDTH), np.float32)

    def entry(c):
        lo3, hi3 = box(c)
        if is_leaf_node(c):
            ptr, cnt = leaf_entry(c)
            return lo3, hi3, ptr, cnt
        return lo3, hi3, pair_of[int(c)], 0

    # empty child slot: cnt == -1 gates it out; the box is a point at the
    # origin (inf/NaN-free arithmetic)
    empty = (np.zeros(3, np.float32), np.zeros(3, np.float32), 0, -1)

    def fill(rec, half, ent):
        lo3, hi3, ptr, cnt = ent
        base = 8 * half
        rec[base + _MIN: base + _MIN + 3] = lo3
        rec[base + _MAX: base + _MAX + 3] = hi3
        rec[base + _PTR] = float(ptr)
        rec[base + _CNT] = float(cnt)

    for i in internal:
        rec = pairs[pair_of[int(i)]]
        ks = kids(i)
        fill(rec, 0, entry(ks[0]))
        fill(rec, 1, entry(ks[1]) if len(ks) == 2 else empty)

    if root_is_leaf:
        root = len(internal)
        fill(pairs[root], 0, entry(root_node))
        fill(pairs[root], 1, empty)
    else:
        root = pair_of[int(root_node)]

    # longest root->leaf chain through pair records; a two-level tree
    # stacks a top tree above per-mesh trees, so the builders' per-tree
    # depth cap does not bound it by itself
    depth = 1
    chain = [(int(root), 1)]
    while chain:
        rec, d = chain.pop()
        depth = max(depth, d)
        for half in (0, 1):
            if pairs[rec, 8 * half + _CNT] == 0.0:  # internal child
                chain.append((int(pairs[rec, 8 * half + _PTR]), d + 1))
    return pairs, int(root), depth


def pad8(a: np.ndarray) -> np.ndarray:
    """Pad the leading dim to a multiple of 8 (the JAX tables' layout,
    kept so both packages hold the same arrays)."""
    p = (-a.shape[0]) % 8
    if p:
        a = np.concatenate([a, np.zeros((p,) + a.shape[1:], a.dtype)])
    return a


def _bw_operands(v0, e1, e2, nrm):
    """Baldwin–Weber precompute for (T, 3) triangle arrays: the 12
    per-triangle leaf constants ``[n̂(3), n̂·v0, A(3), a3, B(3), b3]``.
    Degenerate (zero-area) triangles get A = B = 0, a3 = b3 = −1, so u < 0
    always rejects."""
    n = np.cross(e1, e2)
    n2 = (n * n).sum(axis=1, keepdims=True)
    safe = np.where(n2 > 0.0, n2, 1.0)
    A = np.cross(e2, n) / safe
    B = np.cross(n, e1) / safe
    a3 = -(v0 * A).sum(axis=1, keepdims=True)
    b3 = -(v0 * B).sum(axis=1, keepdims=True)
    degen = n2 <= 0.0
    A = np.where(degen, 0.0, A)
    B = np.where(degen, 0.0, B)
    a3 = np.where(degen, -1.0, a3)
    b3 = np.where(degen, -1.0, b3)
    dn = (nrm * v0).sum(axis=1, keepdims=True)
    return np.concatenate([nrm, dn, A, a3, B, b3], axis=1).astype(np.float32)


def _check_leaves(first, count, n_prims, nodes):
    """Refuse leaves the kernels would misread: a count below 1 packs as
    the empty-slot code (or drops triangles), a range past ``prim_idx``
    reads garbage."""
    bad = (count < 1) | (first < 0) | (first + count > n_prims)
    if bad.any():
        k = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"BVH leaf node {int(nodes[k])} holds prim_idx range "
            f"[{int(first[k])}, {int(first[k]) + int(count[k])}) of "
            f"{n_prims} primitives (count {int(count[k])}); a leaf needs "
            "count >= 1 inside prim_idx (the builder emitted a bad leaf)"
        )


def check_stack_depth(depth: int) -> None:
    """Refuse a tree whose walk could overflow the traversal stack."""
    if depth > TRAVERSAL_STACK:
        raise ValueError(
            f"packed BVH depth {depth} exceeds the {TRAVERSAL_STACK}-entry "
            "traversal stack; rebuild with larger leaves"
        )


def pack_bvh(bvh, tris, form="bw", fanout=2) -> PackedBVH:
    """Convert a FlatBVH + Triangles into pair records + packed tri rows.

    Leaves larger than ``TRIS_PER_ROW`` span consecutive rows.  ``form``
    picks the leaf operand layout: ``"bw"`` (default) or ``"mt"``.
    """
    if fanout == 4:
        raise ValueError(
            "fanout=4 quad records are a TPU tuning knob and are not "
            "ported (ROADMAP.md ground rules: outputs, not TPU knobs); "
            "use fanout=2"
        )
    if fanout != 2:
        raise ValueError(f"fanout must be 2, got {fanout}")
    if form not in ("mt", "bw"):
        raise ValueError(f"unknown leaf form {form!r} (expected 'mt'|'bw')")
    node_min = bvh.node_min.detach().cpu().numpy().astype(np.float32)
    node_max = bvh.node_max.detach().cpu().numpy().astype(np.float32)
    left = bvh.left.cpu().numpy().astype(np.int64)
    right = bvh.right.cpu().numpy().astype(np.int64)
    is_leaf = bvh.is_leaf.cpu().numpy().astype(np.int64)
    prim_idx = bvh.prim_idx.cpu().numpy().astype(np.int64)

    def host(x):
        return x.detach().cpu().numpy().astype(np.float32)

    v0, e1, e2, nrm = (host(tris.v0), host(tris.e1), host(tris.e2),
                       host(tris.normal))
    mat = host(tris.material)
    bw = _bw_operands(v0, e1, e2, nrm) if form == "bw" else None

    internal = np.nonzero(is_leaf == 0)[0]
    leaves = np.nonzero(is_leaf == 1)[0]
    _check_leaves(left[leaves], right[leaves], prim_idx.shape[0], leaves)

    # --- leaf triangle rows (one pass to size, one to fill)
    total_rows = int(sum(_leaf_rows_needed(int(right[i])) for i in leaves))
    total_rows = max(total_rows, 1)
    tri_rows = np.zeros((total_rows, TRIS_PER_ROW * TRI_STRIDE), np.float32)
    prim_map = np.full(total_rows * TRIS_PER_ROW, -1, np.int32)
    leaf_row = {}
    row = 0
    for i in leaves:
        first, count = int(left[i]), int(right[i])
        leaf_row[int(i)] = row
        prims = prim_idx[first: first + count]
        prim_map[row * TRIS_PER_ROW: row * TRIS_PER_ROW + count] = prims
        tri16 = np.zeros((count, TRI_STRIDE), np.float32)
        if form == "bw":
            tri16[:, 0:12] = bw[prims]
        else:
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

    def kids(i):
        l, r = int(left[i]), int(right[i])
        return [l] if l == r else [l, r]  # l == r: two-level redirect node

    pairs, root, depth = build_pair_records(
        0, internal, kids,
        lambda c: is_leaf[c] == 1,
        lambda c: (leaf_row[int(c)], int(right[c])),
        lambda c: (node_min[c], node_max[c]),
    )
    check_stack_depth(depth)
    max_leaf = int(right[leaves].max()) if leaves.size else 1

    padded_rows = pad8(tri_rows)
    if padded_rows.shape[0] * TRIS_PER_ROW >= 2 ** 24:
        # the same limit as the JAX tables: a float32 winner slot is exact
        # only below 2^24
        raise ValueError(
            f"packed BVH has {padded_rows.shape[0] * TRIS_PER_ROW} tri "
            "slots; slots are exact only below 2^24 — split the mesh"
        )
    prim_map = np.concatenate([
        prim_map,
        np.full((padded_rows.shape[0] - total_rows) * TRIS_PER_ROW, -1,
                np.int32),
    ])
    return PackedBVH(
        pairs=torch.from_numpy(pad8(pairs)),
        tri_rows=torch.from_numpy(padded_rows),
        prim_map=torch.from_numpy(prim_map),
        root=root,
        n_rows=total_rows,
        n_pairs=pairs.shape[0],
        max_leaf=max_leaf,
        depth=depth,
        form=form,
        fanout=fanout,
    )


def attach_packed(scene, form="bw", fanout=2):
    """Pack ``scene.bvh`` + triangles into pair tables and return a scene
    whose ``packed`` field (on the scene's device) feeds the BVH kernels."""
    if scene.bvh is None:
        raise ValueError("attach_packed requires a scene with a built BVH")
    packed = pack_bvh(scene.bvh, scene.triangles, form=form, fanout=fanout)
    return replace(scene, packed=packed.to(scene.device))


def traverse_packed_numpy(packed: PackedBVH, origin, direction, t_min=1e-3):
    """Scalar NumPy oracle over the packed tables (tests only): nearest hit
    (t, normal, mat) for one ray, or (inf, 0, -1)."""
    pairs = packed.pairs.cpu().numpy()
    rows = packed.tri_rows.cpu().numpy()
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [packed.root]
    while stack:
        rec = pairs[stack.pop()]
        for half in range(2):
            b = 8 * half
            lo, hi = rec[b: b + 3], rec[b + 3: b + 6]
            ptr, cnt = int(rec[b + 6]), int(rec[b + 7])
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tn = np.maximum(np.minimum(t0, t1).max(), 0.0)
            tf = np.minimum(np.maximum(t0, t1).min(), best[0])
            if tn > tf or cnt < 0:
                continue
            if cnt == 0:
                stack.append(ptr)
                continue
            for j in range(cnt):
                r, lane = ptr + j // TRIS_PER_ROW, TRI_STRIDE * (j % TRIS_PER_ROW)
                f = rows[r, lane: lane + TRI_STRIDE]
                if packed.form == "bw":
                    n, dn = f[0:3], f[3]
                    den = n @ d
                    if den == 0.0:
                        continue
                    t = (dn - n @ o) / den
                    p = o + t * d
                    u = f[4:7] @ p + f[7]
                    v = f[8:11] @ p + f[11]
                    nrm = n
                else:
                    v0, e1, e2 = f[0:3], f[3:6], f[6:9]
                    pv = np.cross(d, e2)
                    det = e1 @ pv
                    if abs(det) < 1e-9:
                        continue
                    tv = o - v0
                    u = (tv @ pv) / det
                    qv = np.cross(tv, e1)
                    v = (d @ qv) / det
                    t = (e2 @ qv) / det
                    nrm = f[9:12]
                if u >= 0 and v >= 0 and u + v <= 1 and t_min < t < best[0]:
                    best = (t, nrm.copy(), int(f[12]))
    return best
