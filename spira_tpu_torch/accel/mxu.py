"""Superleaf BVH packing: 128-triangle blocks as Plücker coefficient tables.

Counterpart of :mod:`spira_tpu.accel.mxu`, packing the same tree into the
same values.  Möller–Trumbore in Plücker form is linear in per-ray
features: with ``m = o × d`` and per-triangle constants ``n = e1×e2``,
``cu = v0×e2``, ``cv = v0×e1``, ``kt = v0·n``::

    det   = -n·d
    u_num =  e2·m + cu·d          u = u_num / det
    v_num = -e1·m - cv·d          v = v_num / det
    t_num =  n·o  - kt            t = t_num / det

Per block (lane j = triangle j of the block), three tables of 8 rows:

* ``coeff_uv`` (8, 384): [det | u_num | v_num] against the ray features
  F_uv = [m(3), d(3), 0, 0] — lanes 0:128 det (rows 3:6 = -n), 128:256
  u_num (rows 0:3 = e2, 3:6 = cu), 256:384 v_num (-e1, -cv);
* ``coeff_t`` (8, 128): t_num against F_o1 = [o(3), 0, 0, 0, 1, 0] (rows
  0:3 = n, row 6 = -kt);
* ``coeff_pay`` (8, 128): rows 0:3 the unit shading normal, row 3 the
  material id.

Empty lanes are all zero: det == 0, so u/v/t are inf or NaN and every hit
condition fails.  The cut nodes (the highest with at most ``superleaf``
triangles) are bin-packed into shared blocks, first fit decreasing: a
block visit reached through one cut node also tests the triangles of the
others in its block, which is correct since they are real geometry.

Two trees lead to the blocks: :class:`MXUBVH` (16-wide rows, the
streaming engine reads only its blocks) and :class:`SuperleafBVH` (pair
records, walked by the packed-BVH kernel with block leaves).  Packing is
host-side NumPy; the tables stay on the CPU until the caller moves them.

The CUDA kernels read the same coefficients lane-major
(:class:`LaneRecords`, each tree's ``lanes``): one record of
:data:`LANE_RECORD` floats a lane, for the real lanes of each block only,
derived from the tables on their device once per tree object.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import replace, tensor_dataclass
from .pairs import build_pair_records, pad8
from .wide import SLOT, WIDTH, _collapse16, binary_kids, host_tree, wide_slot

#: triangles per superleaf block (coefficient lane width)
SUPERLEAF = 128
#: rows per superleaf in each coefficient table
BLOCK_ROWS = 8
#: floats of a lane's record: coeff_uv rows 0-5 of its det, u_num and
#: v_num columns, coeff_t rows 0-2 and 6, then 2 zeros (six float4s)
LANE_RECORD = 24
#: lanes of a group box (:func:`lane_group_bounds`), and groups a block
LANE_GROUP = 16
GROUPS = SUPERLEAF // LANE_GROUP
#: a group box's outward padding, relative to 1 + the largest coordinate
#: magnitude of its triangles
GROUP_PAD = 1e-3


@tensor_dataclass
class LaneRecords:
    """The real lanes of every superleaf block as lane-major records.

    ``records[offsets[b] + j]`` is lane j of block b for j < ``offsets[b +
    1] - offsets[b]``, the block's real lanes: up to its last lane with a
    non-zero coefficient in ``coeff_uv`` or ``coeff_t``.  The lanes after it
    are all zero (det == 0) and never hit, so a visit that skips them keeps
    every bit.  The payload stays in ``coeff_pay``."""

    records: torch.Tensor  # (n_lanes, LANE_RECORD) float32
    offsets: torch.Tensor  # (n_blocks + 1,) int32, offsets[0] == 0
    n_lanes: int = 0
    max_lanes: int = 0  # the most real lanes of one block


def lane_records(coeff_uv, coeff_t) -> LaneRecords:
    """:class:`LaneRecords` of coefficient tables (B*8, 384) and (B*8,
    128), on their device; values copied, never rounded."""
    uv = coeff_uv.reshape(-1, BLOCK_ROWS, 3, SUPERLEAF)
    tc = coeff_t.reshape(-1, BLOCK_ROWS, SUPERLEAF)
    full = torch.zeros((uv.shape[0], SUPERLEAF, LANE_RECORD),
                       dtype=torch.float32, device=coeff_uv.device)
    for s in range(3):  # det, u_num, v_num: rows 0-5 of each column group
        full[:, :, 6 * s: 6 * s + 6] = uv[:, 0:6, s].transpose(1, 2)
    full[:, :, 18:21] = tc[:, 0:3].transpose(1, 2)
    full[:, :, 21] = tc[:, 6]
    nonzero = (uv != 0).any(dim=1).any(dim=1) | (tc != 0).any(dim=1)
    lane = torch.arange(1, SUPERLEAF + 1, device=coeff_uv.device)
    counts = torch.where(nonzero, lane, 0).amax(dim=1)
    real = lane - 1 < counts[:, None]
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return LaneRecords(records=full[real].contiguous(),
                       offsets=offsets.to(torch.int32),
                       n_lanes=int(offsets[-1]),
                       max_lanes=int(counts.max()) if counts.numel() else 0)


def lane_vertices(coeff_uv, coeff_t):
    """The triangles of a packing's lanes, (B, 128, 3, 3) float64 (v0,
    v0 + e1, v0 + e2), from its coefficients on the host: e1 and e2 are
    stored as they are; v0 is the least-squares solution, in float64, of
    v0 . n = kt, v0 x e2 = cu and v0 x e1 = cv.  Also (B, 128) bool: the
    lanes whose triangle this recovers (a non-degenerate n; the others have
    NaN vertices)."""
    uv = coeff_uv.detach().cpu().double().reshape(-1, BLOCK_ROWS, 3,
                                                   SUPERLEAF)
    tc = coeff_t.detach().cpu().double().reshape(-1, BLOCK_ROWS, SUPERLEAF)
    e2 = uv[:, 0:3, 1].transpose(1, 2)  # u_num m part
    e1 = -uv[:, 0:3, 2].transpose(1, 2)  # v_num m part
    cu = uv[:, 3:6, 1].transpose(1, 2)  # v0 x e2
    cv = -uv[:, 3:6, 2].transpose(1, 2)  # v0 x e1
    n = tc[:, 0:3].transpose(1, 2)
    kt = -tc[:, 6]

    def skew(a):  # skew(a) @ b == a x b
        z = torch.zeros_like(a[..., 0])
        return torch.stack([
            torch.stack([z, -a[..., 2], a[..., 1]], -1),
            torch.stack([a[..., 2], z, -a[..., 0]], -1),
            torch.stack([-a[..., 1], a[..., 0], z], -1)], -2)

    # v0 x e = -skew(e) v0: the rows of the 7x3 system
    a = torch.cat([n[..., None, :], -skew(e2), -skew(e1)], -2)
    b = torch.cat([kt[..., None], cu, cv], -1)
    ata = a.transpose(-1, -2) @ a
    ok = (n * n).sum(-1) > 0
    ata = torch.where(ok[..., None, None], ata,
                      torch.eye(3, dtype=ata.dtype))
    v0 = torch.linalg.solve(ata, (a.transpose(-1, -2) @ b[..., None]))[..., 0]
    verts = torch.stack([v0, v0 + e1, v0 + e2], -2)
    return torch.where(ok[..., None, None], verts, torch.nan), ok


def lane_group_bounds(coeff_uv, coeff_t, offsets):
    """Boxes over groups of :data:`LANE_GROUP` lanes of each block, the
    table of #2b's pruning visit: (B * 8 * 2, 4) float32 on the tables'
    device, group g of block b at rows 2 (8 b + g) and 2 (8 b + g) + 1 as a
    pair record's half: (min.xyz, max.x), (max.yz, 0, count), count 1 for a
    group with a real lane, -1 for none (a ray never enters it).

    Each box holds its real lanes' triangles (:func:`lane_vertices`),
    padded outward by :data:`GROUP_PAD` times 1 + their largest coordinate
    magnitude and rounded outward to float32, so a ray's slab entry is
    below a hit's distance in t with room for both computations' rounding.
    A group holding a lane whose triangle is not recovered takes every
    point (±1e30), and is never skipped."""
    verts, ok = lane_vertices(coeff_uv, coeff_t)
    n_blocks = verts.shape[0]
    real = (torch.arange(SUPERLEAF)[None]
            < offsets.detach().cpu().diff().long()[:, None])
    verts = verts.reshape(n_blocks, GROUPS, LANE_GROUP * 3, 3)
    use = real.reshape(n_blocks, GROUPS, LANE_GROUP)
    bad = (use & ~ok.reshape(n_blocks, GROUPS, LANE_GROUP)).any(-1)
    mask = use.repeat_interleave(3, dim=-1)[..., None]
    lo = torch.where(mask, verts, torch.inf).amin(-2)
    hi = torch.where(mask, verts, -torch.inf).amax(-2)
    any_real = use.any(-1)
    big = torch.where(any_real[..., None], torch.maximum(lo.abs(), hi.abs()),
                      0.0).amax(-1, keepdim=True)
    pad = GROUP_PAD * (1.0 + big)
    lo = torch.where(bad[..., None], -1e30, lo - pad)
    hi = torch.where(bad[..., None], 1e30, hi + pad)
    lo = torch.where(any_real[..., None], lo, 0.0)
    hi = torch.where(any_real[..., None], hi, 0.0)
    lo32, hi32 = lo.float(), hi.float()
    # round outward: a float32 box that contains the float64 one
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(
        lo32, torch.tensor(-torch.inf)), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(
        hi32, torch.tensor(torch.inf)), hi32)
    out = torch.zeros((n_blocks, GROUPS, 2, 4), dtype=torch.float32)
    out[:, :, 0, 0:3], out[:, :, 0, 3] = lo32, hi32[..., 0]
    out[:, :, 1, 0:2] = hi32[..., 1:3]
    out[:, :, 1, 3] = torch.where(any_real, 1.0, -1.0)
    return out.reshape(-1, 4).to(coeff_uv.device)


def _groups(self) -> torch.Tensor:
    """The tables' group boxes (:func:`lane_group_bounds`), derived on
    first use and kept with this object."""
    return lane_group_bounds(self.coeff_uv, self.coeff_t, self.lanes.offsets)


def _lanes(self) -> LaneRecords:
    """The tables' lane-major records (:func:`lane_records`), derived on
    first use and kept with this object (a moved or replaced tree derives
    its own)."""
    return lane_records(self.coeff_uv, self.coeff_t)


@tensor_dataclass
class MXUBVH:
    """Shallow 16-wide BVH over Plücker superleaf blocks."""

    nodes: torch.Tensor  # (N, 128) float32 wide-node rows
    coeff_uv: torch.Tensor  # (n_leaves * 8, 384) float32: [det | u | v]
    coeff_t: torch.Tensor  # (n_leaves * 8, 128) float32: t_num
    coeff_pay: torch.Tensor  # (n_leaves * 8, 128) float32: normal, mat id
    root: int = 0
    n_nodes: int = 0
    n_leaves: int = 0

    lanes = functools.cached_property(_lanes)


@tensor_dataclass
class SuperleafBVH:
    """Pair-record tree over superleaf blocks.

    ``pairs`` rows follow :class:`spira_tpu_torch.accel.pairs.PackedBVH`,
    except that a leaf child's ``ptr`` is a block index into the
    coefficient tables (rows ``ptr*8 : ptr*8+8``) and its ``count`` is the
    cut node's triangle count (a walk only tests it ``> 0``: a block visit
    tests the block's lanes, all 128 in the plain version, the real ones in
    the kernel).
    """

    pairs: torch.Tensor  # (P, 16) float32 pair records
    coeff_uv: torch.Tensor  # (n_blocks * 8, 384) float32
    coeff_t: torch.Tensor  # (n_blocks * 8, 128) float32
    coeff_pay: torch.Tensor  # (n_blocks * 8, 128) float32
    root: int = 0
    n_pairs: int = 0
    n_blocks: int = 0
    depth: int = 1  # pair records on the longest root->leaf chain

    lanes = functools.cached_property(_lanes)
    groups = functools.cached_property(_groups)


def _leaf_blocks(v0, e1, e2, nrm, mat):
    """Per-superleaf (uv (8,384), t (8,128), pay (8,128)) coefficients."""
    k = v0.shape[0]
    uv = np.zeros((BLOCK_ROWS, 3 * SUPERLEAF), np.float32)
    tb = np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)
    pay = np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)
    n = np.cross(e1, e2)
    cu = np.cross(v0, e2)
    cv = np.cross(v0, e1)
    kt = np.sum(v0 * n, axis=1)
    uv[3:6, 0:k] = -n.T  # det: d part
    uv[0:3, 128: 128 + k] = e2.T  # u_num: m part
    uv[3:6, 128: 128 + k] = cu.T  # u_num: d part
    uv[0:3, 256: 256 + k] = -e1.T  # v_num: m part
    uv[3:6, 256: 256 + k] = -cv.T  # v_num: d part
    tb[0:3, :k] = n.T  # t_num: o part
    tb[6, :k] = -kt  # t_num: const part
    pay[0:3, :k] = nrm.T  # unit shading normal
    pay[3, :k] = mat  # material id
    return uv, tb, pay


def _cut_and_blocks(left, right, is_leaf, prim_idx, v0, e1, e2, nrm, mat,
                    kids, n_bin, superleaf):
    """Superleaf cut and block packing shared by both trees: returns
    ``(is_cut, leaf_id, tricount, uv_blocks, t_blocks, pay_blocks)`` where
    ``leaf_id`` maps a cut node to its block index."""
    # subtree triangle counts (iterative post-order)
    tricount = np.zeros(n_bin, np.int64)
    post = []
    stk = [0]
    while stk:
        i = stk.pop()
        post.append(i)
        if is_leaf[i] == 0:
            stk.extend(kids(i))
    for i in reversed(post):
        tricount[i] = (
            int(right[i]) if is_leaf[i] == 1
            else sum(tricount[c] for c in kids(i))
        )

    # cut set: highest nodes with <= superleaf triangles
    is_cut = np.zeros(n_bin, bool)
    stk = [0]
    cut_nodes = []
    while stk:
        i = stk.pop()
        if tricount[i] <= superleaf:
            is_cut[i] = True
            cut_nodes.append(i)
        else:
            stk.extend(kids(i))

    def subtree_prims(i: int):
        out, s = [], [i]
        while s:
            j = s.pop()
            if is_leaf[j] == 1:
                first, count = int(left[j]), int(right[j])
                out.extend(prim_idx[first: first + count].tolist())
            else:
                s.extend(kids(j))
        return out

    # bin-pack cut nodes into shared 128-lane blocks, first fit decreasing
    order = sorted(cut_nodes, key=lambda i: -int(tricount[i]))
    leaf_id = {}
    bins: list[list[int]] = []  # prim lists per block
    space: list[int] = []
    for i in order:
        prims = subtree_prims(i)
        k = next(
            (b for b in range(len(bins)) if space[b] >= len(prims)), None
        )
        if k is None:
            k = len(bins)
            bins.append([])
            space.append(SUPERLEAF)
        leaf_id[i] = k
        bins[k].extend(prims)
        space[k] -= len(prims)

    uv_blocks, t_blocks, pay_blocks = [], [], []
    for prim_list in bins:
        prims = np.asarray(prim_list, np.int64)
        uv, tb, pay = _leaf_blocks(
            v0[prims], e1[prims], e2[prims], nrm[prims], mat[prims]
        )
        uv_blocks.append(uv)
        t_blocks.append(tb)
        pay_blocks.append(pay)
    if not uv_blocks:
        uv_blocks = [np.zeros((BLOCK_ROWS, 3 * SUPERLEAF), np.float32)]
        t_blocks = [np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)]
        pay_blocks = [np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)]
    return is_cut, leaf_id, tricount, uv_blocks, t_blocks, pay_blocks


def _cut(bvh, tris, superleaf):
    if not 1 <= superleaf <= SUPERLEAF:
        raise ValueError(f"superleaf must be in 1..{SUPERLEAF}")
    (node_min, node_max, left, right, is_leaf, prim_idx, v0, e1, e2, nrm,
     mat) = host_tree(bvh, tris)
    kids = binary_kids(left, right)
    cut = _cut_and_blocks(left, right, is_leaf, prim_idx, v0, e1, e2, nrm,
                          mat, kids, node_min.shape[0], superleaf)
    return (node_min, node_max, right, is_leaf, kids) + cut


def _tables(uv_blocks, t_blocks, pay_blocks):
    return dict(
        coeff_uv=torch.from_numpy(np.concatenate(uv_blocks, axis=0)),
        coeff_t=torch.from_numpy(np.concatenate(t_blocks, axis=0)),
        coeff_pay=torch.from_numpy(np.concatenate(pay_blocks, axis=0)),
    )


def pack_bvh_mxu(bvh, tris, superleaf: int = SUPERLEAF) -> MXUBVH:
    """Collapse a binary FlatBVH + Triangles into wide nodes over superleaf
    blocks (host tables, on the CPU).

    A binary node becomes a superleaf when its subtree holds at most
    ``superleaf`` triangles and its parent's does not; the structure above
    the cut is 16-wide packed as :func:`spira_tpu_torch.accel.wide.
    pack_bvh16` packs it.  Blocks stay 128 lanes wide for any
    ``superleaf``.
    """
    (node_min, node_max, _, _, kids, is_cut, leaf_id, tricount, uv_blocks,
     t_blocks, pay_blocks) = _cut(bvh, tris, superleaf)
    nodes, n_nodes = _collapse16(
        node_min, node_max, kids, is_cut,
        leaf_ptr=lambda i: leaf_id[i],
        leaf_cnt=lambda i: int(tricount[i]),
        subtree_weight=tricount,
    )
    return MXUBVH(
        nodes=torch.from_numpy(nodes),
        **_tables(uv_blocks, t_blocks, pay_blocks),
        root=0,
        n_nodes=n_nodes,
        n_leaves=len(uv_blocks),
    )


def pack_bvh_superleaf(bvh, tris, superleaf: int = SUPERLEAF) -> SuperleafBVH:
    """Pack a FlatBVH + Triangles into pair records over superleaf blocks
    (host tables, on the CPU)."""
    (node_min, node_max, right, is_leaf, kids, is_cut, leaf_id, tricount,
     uv_blocks, t_blocks, pay_blocks) = _cut(bvh, tris, superleaf)
    if is_leaf.size and int(right[is_leaf == 1].max(initial=0)) > superleaf:
        raise ValueError(
            "builder leaves exceed the superleaf size; rebuild the BVH with "
            f"leaf_size <= {superleaf}"
        )
    # pair records over the contracted tree (internal nodes above the cut)
    internal = []
    if not is_cut[0]:
        stk = [0]
        while stk:
            i = stk.pop()
            internal.append(i)
            stk.extend(c for c in kids(i) if not is_cut[c])

    pairs, root, depth = build_pair_records(
        0,
        internal,
        kids,
        lambda c: is_cut[c],
        lambda c: (leaf_id[c], int(tricount[c])),
        lambda c: (node_min[c], node_max[c]),
    )
    return SuperleafBVH(
        pairs=torch.from_numpy(pad8(pairs)),
        **_tables(uv_blocks, t_blocks, pay_blocks),
        root=int(root),
        n_pairs=pairs.shape[0],
        n_blocks=len(uv_blocks),
        depth=depth,
    )


def attach_mxu(scene, superleaf: int = SUPERLEAF):
    """Pack ``scene.bvh`` into wide superleaf tables on ``scene.wide`` (on
    the scene's device): the tables the streaming engine reads."""
    if scene.bvh is None:
        raise ValueError("attach_mxu requires a scene with a built BVH")
    return replace(scene, wide=pack_bvh_mxu(
        scene.bvh, scene.triangles, superleaf).to(scene.device))


def attach_superleaf(scene, superleaf: int = SUPERLEAF):
    """Pack ``scene.bvh`` into pair-tree superleaf tables on
    ``scene.wide`` (on the scene's device): the tables the packed-BVH
    kernel walks with ``mxu_leaf=True``."""
    if scene.bvh is None:
        raise ValueError("attach_superleaf requires a scene with a built BVH")
    return replace(scene, wide=pack_bvh_superleaf(
        scene.bvh, scene.triangles, superleaf).to(scene.device))


def _block_numpy(cuv, ct, cpay, block, o, d, best, t_min):
    """One block of the packed tables against one ray, in float64: the
    nearest lane hit below ``best`` as (t, normal, mat), or ``best``."""
    m = np.cross(o, d)
    f_uv = np.concatenate([m, d, [0.0, 0.0]])
    f_o1 = np.concatenate([o, [0.0, 0.0, 0.0], [1.0, 0.0]])
    base = block * BLOCK_ROWS
    quv = cuv[base: base + 8].T @ f_uv  # (384,)
    det, un, vn = quv[0:128], quv[128:256], quv[256:384]
    tn = ct[base: base + 8].T @ f_o1
    ok = np.abs(det) > 1e-12
    idet = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    u = un * idet
    v = vn * idet
    t = np.where(ok, tn * idet, np.inf)
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
    t = np.where(hit, t, np.inf)
    j = int(np.argmin(t))
    if t[j] < best[0]:
        pay = cpay[base: base + 8, j]
        return float(t[j]), pay[0:3].copy(), int(pay[3])
    return best


def _slab_numpy(lo, hi, o, inv, best_t):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = max(np.minimum(t0, t1).max(), 0.0)
    tf = min(np.maximum(t0, t1).min(), best_t)
    return not tn > tf


def _coeffs64(packed):
    return (packed.coeff_uv.cpu().numpy().astype(np.float64),
            packed.coeff_t.cpu().numpy().astype(np.float64),
            packed.coeff_pay.cpu().numpy().astype(np.float64))


def traverse_mxu_numpy(packed: MXUBVH, origin, direction, t_min=1e-3):
    """Scalar NumPy oracle over the packed wide tables (tests only):
    nearest hit (t, normal, mat) for one ray, or (inf, 0, -1)."""
    nodes = packed.nodes.cpu().numpy()
    cuv, ct, cpay = _coeffs64(packed)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [packed.root]
    while stack:
        rec = nodes[stack.pop()]
        for c in range(WIDTH):
            lo, hi, ptr, cnt = wide_slot(rec, c)
            if cnt < 0 or not _slab_numpy(lo, hi, o, inv, best[0]):
                continue
            if cnt == 0:
                stack.append(int(ptr))
            else:
                best = _block_numpy(cuv, ct, cpay, int(ptr), o, d, best,
                                    t_min)
    return best


def traverse_superleaf_numpy(packed: SuperleafBVH, origin, direction,
                             t_min=1e-3):
    """Scalar NumPy oracle over the SuperleafBVH tables (tests only):
    nearest hit (t, normal, mat) for one ray, or (inf, 0, -1): the
    pair-record walk of ``pairs.traverse_packed_numpy`` with the block
    evaluation of :func:`traverse_mxu_numpy`."""
    pairs = packed.pairs.cpu().numpy()
    cuv, ct, cpay = _coeffs64(packed)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [packed.root]
    while stack:
        rec = pairs[stack.pop()]
        for half in (0, 1):
            b = SLOT * half
            ptr, cnt = int(rec[b + 6]), int(rec[b + 7])
            if cnt < 0 or not _slab_numpy(rec[b: b + 3], rec[b + 3: b + 6],
                                          o, inv, best[0]):
                continue
            if cnt == 0:
                stack.append(ptr)
            else:
                best = _block_numpy(cuv, ct, cpay, ptr, o, d, best, t_min)
    return best
