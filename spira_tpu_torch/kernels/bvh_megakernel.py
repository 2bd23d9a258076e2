"""Packed-BVH path tracer (mesh scenes, physical semantics, RGB): the host
side, the plain PyTorch walk, and the wrappers of the two CUDA kernels.

Counterpart of :mod:`spira_tpu.kernels.bvh_megakernel`.  The JAX package
walks the pair-record tree with a whole (tile_h, 128) packet of rays at
once, driven by one scalar stack; on Hopper each ray walks the tree on its
own (one thread per ray, a private stack).  Traversal order cannot change
the nearest hit, so both give the same image up to ties between triangles
at equal distance.

* :func:`render_flat_bvh_megakernel` — the CUDA path tracer
  (``csrc/bvh_megakernel.cu``, kernel ``spira_bvh_megakernel_render``) for
  scenes on a CUDA device; for scenes on the CPU it runs
  :func:`render_flat_bvh_fused`.
* :func:`intersect_tile` — the CUDA nearest-hit query
  (``spira_bvh_intersect``) for rays on a CUDA device; on the CPU,
  :func:`intersect_packed_plain`.  :func:`make_sorted_tile_intersect`
  makes it the wavefront estimator's nearest-hit hook.
* :func:`render_bvh_with_counters` — the counting build of the CUDA path
  tracer (``spira_bvh_megakernel_render_counted``): the same image and the
  frame's work counters; on the CPU, :func:`render_bvh_counters_fused`.
* :func:`render_flat_bvh_mxu_megakernel` — the same tracer and walk over
  a :class:`~spira_tpu_torch.accel.mxu.SuperleafBVH` whose leaves are
  128-triangle Plücker blocks (``spira_bvh_mxu_render``, kernel #2b:
  each block visit served by the whole warp, its lane groups pruned by
  their boxes, ``csrc/superleaf.cuh:walk_blocks_warp``);
  ``render_flat_bvh_megakernel(..., mxu_leaf=True)`` runs it.
* The plain version: :func:`packed_walk`, a per-ray depth-first stack walk
  vectorised over all rays in lockstep, with a leaf visitor for row leaves
  (:func:`_leaf_hits`) or superleaf blocks (:func:`_block_hits`), and
  :func:`make_packed_intersect`, the ``intersect_fn`` it gives
  :func:`megakernel.trace_tile`.

The walk, shared by the kernel and the plain version: spheres first (their
nearest hit seeds ``best_t``); then pop a pair record, slab-test both
children against the ray's ``best_t`` at the pop (near side clamped at 0);
visit hit leaves at once, nearer child first; push hit internal children
far first, so the nearer one pops next.  Children are ordered by their
clamped entry distance, the earlier slot winning a tie.  Leaf triangles are
tested in slot order with a strict ``t < best_t``, so the first of equal
hits wins in both versions.  A superleaf block tests its lanes in order
with the same strict ``t < best_t``, so the lowest lane of equal hits wins:
the kernel its real lanes as lane records
(:class:`~spira_tpu_torch.accel.mxu.LaneRecords`), the plain version all
128 of the packed tables, whose padding lanes never hit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..accel.mxu import (BLOCK_ROWS, GROUPS, LANE_GROUP, LANE_RECORD,
                         SUPERLEAF, SuperleafBVH)
from ..accel.pairs import TRI_STRIDE, TRIS_PER_ROW, check_stack_depth
from ..accel.traverse import _winner_triangle_hit
from ..core.vecmath import INF
from ..integrator.intersect import Hit, intersect_spheres, merge_hits
from ..utils.profiling import annotate
from . import megakernel as mk

#: width of the material table (:func:`pack_materials`).
N_MAT_FIELDS = 16
#: the work counters of :func:`render_bvh_with_counters`, in the counting
#: kernel's order (``csrc/bvh.cuh:WalkCounts``)
COUNTERS = ("pops", "pushes", "traversals", "leaf_visits", "leaf_tris",
            "leaf_visits_primary", "hits")


def pack_materials(materials):
    """(M, 16) material table: albedo, emission, metallic, roughness, ior,
    transmission, then 6 zeros (differentiable in every field)."""
    m = materials.count
    return torch.cat(
        [
            materials.albedo,
            materials.emission,
            materials.metallic[:, None],
            materials.roughness[:, None],
            materials.ior[:, None],
            materials.transmission[:, None],
            materials.albedo.new_zeros((m, 6)),
        ],
        dim=1,
    )


def _require_tree(scene, mxu_leaf: bool = False):
    """The tables the kernels walk: ``scene.packed`` (row leaves), or with
    ``mxu_leaf`` the :class:`SuperleafBVH` on ``scene.wide`` (superleaf
    blocks)."""
    if mxu_leaf:
        if not isinstance(scene.wide, SuperleafBVH):
            raise ValueError(
                "mxu_leaf=True needs a SuperleafBVH on scene.wide; call "
                "spira_tpu_torch.accel.mxu.attach_superleaf"
            )
        return _check_packed(scene.wide)
    if scene.packed is None:
        raise ValueError(
            "scene has no packed BVH; call "
            "spira_tpu_torch.accel.pairs.attach_packed"
        )
    return _check_packed(scene.packed)


def _check_packed(packed):
    """Refuse tables the walk cannot take: other record arities or leaf
    forms, and trees deeper than the traversal stack."""
    if isinstance(packed, SuperleafBVH):
        check_stack_depth(packed.depth)
        return packed
    if packed.fanout != 2 or packed.form not in ("bw", "mt"):
        raise ValueError(f"packed BVH with fanout {packed.fanout}, form "
                         f"{packed.form!r}: the walk takes pair records in "
                         "form 'bw' or 'mt'")
    check_stack_depth(packed.depth)
    return packed


# ----------------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------------

def _slab(rec, half, o, inv, best):
    """Slab test of one child of each record: (hit, clamped entry distance,
    ptr, count)."""
    b = 8 * half
    t0 = (rec[:, b:b + 3] - o) * inv
    t1 = (rec[:, b + 3:b + 6] - o) * inv
    mn = torch.minimum(t0, t1)
    mx = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
    tf = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
    tn = torch.clamp(tn, min=0.0)
    cnt = rec[:, b + 7]
    hit = (tn <= torch.minimum(tf, best)) & (cnt > -0.5)
    return hit, tn, rec[:, b + 6].long(), cnt


def _leaf_hits(slots, form, max_leaf, ptr, cnt, o, d, best):
    """Nearest hit among each ray's leaf triangles (slots ptr*8 + j,
    j < cnt) that beats ``best``: (won, t, normal, mat, slot).  The first
    of equal hits wins, as in a sequential strict-less scan."""
    j = torch.arange(max_leaf, device=o.device)
    slot = ptr[:, None] * TRIS_PER_ROW + j
    valid = j < cnt[:, None]
    f = slots[torch.where(valid, slot, 0)]  # (L, J, 16)
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    if form == "bw":
        nbx, nby, nbz = f[..., 0], f[..., 1], f[..., 2]
        den = nbx * dx + nby * dy + nbz * dz
        num = f[..., 3] - (nbx * ox + nby * oy + nbz * oz)
        r0 = 1.0 / den
        tt = num * (r0 * (2.0 - den * r0))
        px = ox + tt * dx
        py = oy + tt * dy
        pz = oz + tt * dz
        uu = f[..., 4] * px + f[..., 5] * py + f[..., 6] * pz + f[..., 7]
        vv = f[..., 8] * px + f[..., 9] * py + f[..., 10] * pz + f[..., 11]
        ok = valid
        nrm = f[..., 0:3]
    else:
        v0x, v0y, v0z = f[..., 0], f[..., 1], f[..., 2]
        e1x, e1y, e1z = f[..., 3], f[..., 4], f[..., 5]
        e2x, e2y, e2z = f[..., 6], f[..., 7], f[..., 8]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = 1.0 / det
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = valid & (torch.abs(det) > 1e-9)
        nrm = f[..., 9:12]
    ok = (ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > mk.T_MIN) & (tt < best[:, None]))
    k = torch.argmin(torch.where(ok, tt, torch.inf), dim=1, keepdim=True)
    won = ok.gather(1, k)[:, 0]
    pick = f.gather(1, k[:, :, None].expand(-1, 1, TRI_STRIDE))[:, 0]
    return (won, tt.gather(1, k)[:, 0], nrm.gather(
        1, k[:, :, None].expand(-1, 1, 3))[:, 0], pick[:, 12],
        slot.gather(1, k)[:, 0])


def block_views(tables):
    """The coefficient tables of a superleaf packing as (blocks, 8, 384),
    (blocks, 8, 128) and (blocks, 8, 128) views."""
    return (tables.coeff_uv.view(-1, BLOCK_ROWS, 3 * SUPERLEAF),
            tables.coeff_t.view(-1, BLOCK_ROWS, SUPERLEAF),
            tables.coeff_pay.view(-1, BLOCK_ROWS, SUPERLEAF))


def lane_hits(uv, tc, o, d, best, keep=None):
    """The superleaf lane test of ``csrc/superleaf.cuh:lane_hit``: the
    nearest of a block's 128 lanes that beats ``best``, for each ray.

    uv (..., 8, 384) and tc (..., 8, 128): the block's coefficient rows
    (one block for all rays, or one per ray); o, d (L, 3); best (L,).
    Each lane sums its column of rows 0-5 against F_uv = [m, d] and of
    rows 0-2 and 6 against F_o1 = [o, 1], left to right (the rows that
    meet a zero feature are left out), then takes ``idet = 1/det``, u, v
    and t, and the hit test of ``spira_tpu/kernels/mxu_megakernel.py:
    129-135``.  Returns (won (L,) bool, t (L,), lane (L,) long): the
    lowest lane of equal t, as a strict-``<`` scan in lane order finds
    it.  ``keep`` (L, 128) bool, if given, leaves the lanes it clears
    out."""
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    feats = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
             dx, dy, dz)
    q = uv[..., 0, :] * feats[0]
    for k in range(1, 6):
        q = q + uv[..., k, :] * feats[k]
    tn = tc[..., 0, :] * ox + tc[..., 1, :] * oy
    tn = tn + tc[..., 2, :] * oz
    tn = tn + tc[..., 6, :]
    det = q[:, :SUPERLEAF]
    idet = 1.0 / det  # padding lanes: det == 0, every compare fails
    uu = q[:, SUPERLEAF:2 * SUPERLEAF] * idet
    vv = q[:, 2 * SUPERLEAF:] * idet
    tt = tn * idet
    hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > mk.T_MIN)
           & (tt < best[:, None]) & (det.abs() > 1e-12))
    if keep is not None:
        hit = hit & keep
    tt = torch.where(hit, tt, torch.inf)
    lane = torch.argmin(tt, dim=1)
    t = tt.gather(1, lane[:, None])[:, 0]
    return t < best, t, lane


def _block_hits(views, ptr, o, d, best):
    """Nearest hit among the 128 lanes of each ray's block ``ptr`` that
    beats ``best``: (won, t, normal, mat, slot = block * 128 + lane)."""
    uv, tc, pay = views
    won, t, lane = lane_hits(uv[ptr], tc[ptr], o, d, best)
    rows = pay[ptr, 0:4].gather(2, lane[:, None, None].expand(-1, 4, 1))
    return won, t, rows[:, 0:3, 0], rows[:, 3, 0], ptr * SUPERLEAF + lane


def block_hits_pruned(views, groups, ptr, o, d, best):
    """:func:`_block_hits` leaving out the lanes of each group whose box
    (``groups``: :func:`~spira_tpu_torch.accel.mxu.lane_group_bounds`) the
    ray does not enter at a distance up to ``best`` (the walk's slab test,
    :func:`_slab`): the plain version of #2b's pruning visit
    (``csrc/superleaf.cuh:group_mask``), which gives the same hits because
    the boxes are padded.  Also returns the (L, 8) groups entered."""
    uv, tc, pay = views
    inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)
    boxes = groups.view(-1, GROUPS, 8)[ptr]
    enter = torch.stack([_slab(boxes[:, g], 0, o, inv, best)[0]
                         for g in range(GROUPS)], 1)
    won, t, lane = lane_hits(uv[ptr], tc[ptr], o, d, best,
                             keep=enter.repeat_interleave(LANE_GROUP, 1))
    rows = pay[ptr, 0:4].gather(2, lane[:, None, None].expand(-1, 4, 1))
    return (won, t, rows[:, 0:3, 0], rows[:, 3, 0], ptr * SUPERLEAF + lane,
            enter)


def _pruned_visitor(packed):
    """``visit(ptr, cnt, o, d, best) -> (won, t, normal, mat, slot,
    lanes tested)`` over the blocks of a SuperleafBVH, as #2b visits them:
    :func:`block_hits_pruned`, and the real lanes of the groups it
    enters."""
    views = block_views(packed)
    real = packed.lanes.offsets.diff().long()
    lane = torch.arange(SUPERLEAF, device=real.device)

    def visit(ptr, cnt, o, d, best):
        *hits, enter = block_hits_pruned(views, packed.groups, ptr, o, d,
                                         best)
        tested = (enter.repeat_interleave(LANE_GROUP, 1)
                  & (lane[None] < real[ptr][:, None])).sum(1)
        return (*hits, tested)

    return visit


def _leaf_visitor(packed):
    """``visit(ptr, cnt, o, d, best) -> (won, t, normal, mat, slot)`` over
    the leaves of ``packed``: superleaf blocks or rows of triangles."""
    if isinstance(packed, SuperleafBVH):
        views = block_views(packed)
        return lambda ptr, cnt, o, d, best: _block_hits(views, ptr, o, d,
                                                        best)
    slots = packed.tri_rows.reshape(-1, TRI_STRIDE)
    return lambda ptr, cnt, o, d, best: _leaf_hits(
        slots, packed.form, packed.max_leaf, ptr, cnt, o, d, best)


def new_counts(n_rays, device):
    """Zeroed per-ray counters (:data:`COUNTERS`, each (N,) int64) for
    :func:`packed_walk`."""
    return {k: torch.zeros(n_rays, dtype=torch.int64, device=device)
            for k in COUNTERS}


def packed_walk(packed, o, d, best, active=None, counts=None,
                primary=False):
    """Nearest triangle hit of each ray over the packed tables (a
    PackedBVH, or a SuperleafBVH whose leaves are blocks), beating
    ``best``: returns (t, normal (N,3), mat id as float (-1: none),
    slot (-1: none)).  o, d: (N, 3); best: (N,) initial search bound;
    ``active``: optional (N,) bool, rays left out keep ``best``.

    Each ray walks depth first with its own stack; all rays advance in
    lockstep, one record per ray and step, and a ray leaves the step set
    when its stack empties.

    ``counts`` (:func:`new_counts`) adds each ray's work to its entries,
    as the counting kernels count it per thread (``csrc/bvh.cuh:
    WalkCounts``): ``traversals`` (this walk), ``pops``, ``pushes``,
    ``leaf_visits``, ``leaf_tris`` and, with ``primary`` (the walk of
    bounce 0), ``leaf_visits_primary``.  Over superleaf blocks the
    counting walk visits them as kernel #2b does, through
    :func:`block_hits_pruned` (the same hits), and ``leaf_tris`` counts
    the lanes it tests: the real lanes of the groups entered."""
    n_rays = o.shape[0]
    dev = o.device
    pairs = packed.pairs
    visit = _leaf_visitor(packed)
    if counts is not None and isinstance(packed, SuperleafBVH):
        visit = _pruned_visitor(packed)
    inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)
    t = best.clone()
    nrm = torch.zeros_like(o)
    mid = torch.full_like(best, -1.0)
    slot = torch.full((n_rays,), -1, dtype=torch.long, device=dev)
    # a depth-first walk holds at most one pending sibling per level
    stack = torch.empty((n_rays, max(packed.depth, 1)), dtype=torch.long,
                        device=dev)
    stack[:, 0] = packed.root
    sp = torch.ones(n_rays, dtype=torch.long, device=dev)
    live = torch.arange(n_rays, device=dev)
    if active is not None:
        live = live[active]
    if counts is not None:
        counts["traversals"][live] += 1
    while live.numel():
        sp[live] -= 1
        if counts is not None:
            counts["pops"][live] += 1
        rec = pairs[stack[live, sp[live]]]
        o_l, d_l, best_l = o[live], d[live], t[live]
        h0, tn0, p0, c0 = _slab(rec, 0, o_l, inv[live], best_l)
        h1, tn1, p1, c1 = _slab(rec, 1, o_l, inv[live], best_l)
        near0 = tn0 <= tn1
        near = (torch.where(near0, h0, h1), torch.where(near0, p0, p1),
                torch.where(near0, c0, c1))
        far = (torch.where(near0, h1, h0), torch.where(near0, p1, p0),
               torch.where(near0, c1, c0))
        for hit, ptr, cnt in (near, far):  # leaves, nearer first
            sel = (hit & (cnt > 0.5)).nonzero()[:, 0]
            if sel.numel():
                g = live[sel]
                won, tw, nw, mw, sw, *tested = visit(
                    ptr[sel], cnt[sel], o_l[sel], d_l[sel], t[g])
                if counts is not None:
                    counts["leaf_visits"][g] += 1
                    counts["leaf_tris"][g] += (tested[0] if tested
                                               else cnt[sel].long())
                    if primary:
                        counts["leaf_visits_primary"][g] += 1
                g = g[won]
                t[g] = tw[won]
                nrm[g] = nw[won]
                mid[g] = mw[won]
                slot[g] = sw[won]
        for hit, ptr, cnt in (far, near):  # internal children, far first
            push = hit & (cnt == 0.0)
            g = live[push]
            if counts is not None:
                counts["pushes"][g] += 1
            stack[g, sp[g]] = ptr[push]
            sp[g] += 1
        live = live[sp[live] > 0]
    return t, nrm, mid, slot


def make_walk_intersect(spheres, walk, mat_table):
    """The ``intersect_fn`` for :func:`megakernel.trace_tile` over a mesh
    scene: the sphere loop seeds ``best_t``, ``walk(o, d, best, active) ->
    (t, normal, mat id, slot)`` beats it, and triangle hits take their
    material row from ``mat_table`` (:func:`pack_materials`)."""

    def intersect(o3, d3, active=None):
        st = mk.init_hit_state(d3[0])
        st = mk.sphere_unroll(spheres, o3, d3, st)
        t, nrm, mid, _ = walk(torch.stack(o3, -1), torch.stack(d3, -1),
                              st["best_t"], active)
        tri = mid >= 0.0
        st["best_t"] = t
        st["hit_is_tri"] = tri
        st["tnx"], st["tny"], st["tnz"] = nrm.unbind(-1)
        rows = mat_table[mid.clamp(min=0.0).long()]
        mk._select_mats(st, tri, tuple(rows[:, k] for k in range(10)))
        return mk.finish_intersect(o3, d3, st)

    return intersect


def make_packed_intersect(spheres, packed, mat_table, counts=None):
    """:func:`make_walk_intersect` over :func:`packed_walk` of ``packed``.

    With ``counts`` (:func:`new_counts` over the pixels) each live ray's
    walk adds its work there, and its hits to ``counts["hits"]``; the
    intersect then sets ``wants_bounce``, so :func:`megakernel.trace_tile`
    passes the bounce and bounce 0 counts its primary leaf visits."""
    if counts is None:
        return make_walk_intersect(
            spheres, lambda o, d, best, active: packed_walk(
                packed, o, d, best, active), mat_table)
    bounce_now = [0]
    inner = make_walk_intersect(
        spheres, lambda o, d, best, active: packed_walk(
            packed, o, d, best, active, counts, primary=bounce_now[0] == 0),
        mat_table)

    def intersect(o3, d3, active=None, bounce=0):
        bounce_now[0] = bounce
        out = inner(o3, d3, active)
        hit = out[0] if active is None else out[0] & active
        counts["hits"] += hit.long()
        return out

    intersect.wants_bounce = True
    return intersect


def sphere_tuples(scene):
    """The sphere table as the tracers' per-sphere scalar tuples."""
    sph_arr = mk.pack_scene(scene)
    return [tuple(sph_arr[k, f] for f in range(14))
            for k in range(scene.spheres.count)]


def check_rows(height, rows):
    """``rows`` = (n_rows, row_start, sample_offset) of a shard of a frame
    ``height`` rows high: the rows it covers, from the bottom, lie in the
    frame and the first sample is not negative."""
    n_rows, row_start, sample_offset = rows
    if n_rows < 1 or row_start < 0 or row_start + n_rows > height:
        raise ValueError(f"rows {row_start} .. {row_start + n_rows - 1} "
                         f"outside a frame of {height} rows")
    if sample_offset < 0:
        raise ValueError(f"sample_offset must be >= 0, got {sample_offset}")


def trace_mesh(scene, camera, intersect_fn, *, width, height, spp,
               max_depth, seed, inclusive_uv, rows=None, normalize=True):
    """Plain mesh render through :func:`megakernel.trace_tile` with
    ``intersect_fn`` → flat (H*W, 3) bottom-up HDR buffer, each pixel's
    mean of ``spp`` samples (with ``normalize=False`` its sum).  ``rows``
    = (n_rows, row_start, sample_offset) renders the ``n_rows`` rows from
    ``row_start`` at the samples from ``sample_offset`` on instead, keyed
    on the global pixel and sample as the whole frame keys them:
    (n_rows*W, 3).  Each call adds one to ``trace_mesh.calls``."""
    trace_mesh.calls += 1
    n_rows, row_start, sample_offset = rows or (height, 0, 0)
    check_rows(height, (n_rows, row_start, sample_offset))
    cam = mk.cam_tuple(mk.pack_camera(camera), camera.has_lens)
    pixel = torch.arange(row_start * width, (row_start + n_rows) * width,
                         dtype=torch.int64, device=scene.device)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    r, g, b = mk.trace_tile(
        pixel,
        (pixel // width).to(torch.float32),
        (pixel % width).to(torch.float32),
        cam,
        (),
        seed=seed,
        spp=spp,
        max_depth=max_depth,
        du=du,
        dv=dv,
        sample_offset=sample_offset,
        intersect_fn=intersect_fn,
    )
    if not normalize:
        return torch.stack([r, g, b], dim=-1)
    inv = mk._inv_spp(spp)
    return torch.stack([r * inv, g * inv, b * inv], dim=-1)


#: Plain mesh renders since the count was last reset (set it to 0 to reset).
trace_mesh.calls = 0


def render_flat_bvh_fused(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    mxu_leaf: bool = False,
    rows=None,
    normalize: bool = True,
):
    """Plain-PyTorch packed-BVH render → flat (H*W, 3) bottom-up HDR
    buffer, on the scene's device.  Same math, walk and RNG as the CUDA
    kernel; ``mxu_leaf`` walks the superleaf tree on ``scene.wide``;
    ``rows`` and ``normalize`` as :func:`trace_mesh` takes them."""
    packed = _require_tree(scene, mxu_leaf)
    intersect = make_packed_intersect(sphere_tuples(scene), packed,
                                      pack_materials(scene.materials))
    return trace_mesh(scene, camera, intersect, width=width, height=height,
                      spp=spp, max_depth=max_depth, seed=seed,
                      inclusive_uv=inclusive_uv, rows=rows,
                      normalize=normalize)


def render_bvh_counters_fused(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    mxu_leaf: bool = False,
):
    """The plain version of :func:`render_bvh_with_counters`: the render
    of :func:`render_flat_bvh_fused` with the walk counting each pixel's
    work; returns (flat (H*W, 3), per-pixel counts {name: (H*W,) int64}).
    ``mxu_leaf`` walks the superleaf tree on ``scene.wide``."""
    packed = _require_tree(scene, mxu_leaf)
    counts = new_counts(width * height, scene.device)
    intersect = make_packed_intersect(sphere_tuples(scene), packed,
                                      pack_materials(scene.materials),
                                      counts)
    flat = trace_mesh(scene, camera, intersect, width=width, height=height,
                      spp=spp, max_depth=max_depth, seed=seed,
                      inclusive_uv=inclusive_uv)
    return flat, counts


def intersect_packed_plain(packed, origins, dirs, active=None,
                           with_slot=False):
    """Plain-PyTorch nearest hit of (N, 3) rays over the packed tables:
    (t (N,), normal (N, 3), mat id (N,) int32[, slot (N,) int32]), with
    t = 1e20, normal 0 and mat id -1 on a miss."""
    _check_packed(packed)
    best = torch.full((origins.shape[0],), mk.INF, dtype=torch.float32,
                      device=origins.device)
    if active is not None:
        active = active.to(torch.bool)
    t, nrm, mid, slot = packed_walk(packed, origins, dirs, best, active)
    out = (t, nrm, mid.to(torch.int32))
    return out + (slot.to(torch.int32),) if with_slot else out


# ----------------------------------------------------------------------------
# The CUDA kernels
# ----------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: a mesh render entry's arguments before and after its tree tables
_RENDER_HEAD = (_VP, _VP, _I, _VP, _I)  # cam, spheres, n_spheres, mats, n_mats
_RENDER_TAIL = (
    _VP, _I, _I, _I, _I,  # out, width, height, spp, max_depth
    ctypes.c_uint32, _F, _F, _F, _I,  # seed, du, dv, inv_spp, has_lens
    _VP,  # stream
)
#: the tail of kernel #2's entries, which take a shard's rows and samples
_ROWS_TAIL = (
    _VP, _I, _I, _I, _I,  # out, width, n_rows, row_start, sample_offset
    _I, _I,  # spp, max_depth
    ctypes.c_uint32, _F, _F, _F, _I,  # seed, du, dv, inv_spp, has_lens
    _VP,  # stream
)
_INTERSECT_ARGTYPES = (
    _VP, _VP, _VP, _I,  # origins, dirs, active (or null), n
    _VP, _VP, _I, _I,  # pairs, tri_rows, root, form_bw
    _VP, _VP, _VP, _VP,  # t, normal, mid, slot (or null)
    _VP,  # stream
)


def _check_aligned(name, t, device, cols):
    mk._check_table(name, t, device, cols)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_root(tree):
    if not 0 <= tree.root < tree.pairs.shape[0]:
        raise ValueError(f"packed root {tree.root} outside the "
                         f"{tree.pairs.shape[0]} pair records")


def _check_tree_tables(packed, device):
    if isinstance(packed, SuperleafBVH):
        raise ValueError("the nearest-hit kernel walks row leaves (a "
                         "PackedBVH), not superleaf blocks")
    _check_aligned("packed pairs", packed.pairs, device, 16)
    _check_aligned("packed tri_rows", packed.tri_rows, device,
                   TRIS_PER_ROW * TRI_STRIDE)
    _check_root(packed)


def check_block_tables(tables, device, n_blocks):
    """The coefficient tables of ``n_blocks`` superleaf blocks, as the
    kernels read them: float32, row-major, on ``device``."""
    for name, cols in (("coeff_uv", 3 * SUPERLEAF), ("coeff_t", SUPERLEAF),
                       ("coeff_pay", SUPERLEAF)):
        t = getattr(tables, name)
        _check_aligned(f"superleaf {name}", t, device, cols)
        if t.shape[0] != n_blocks * BLOCK_ROWS:
            raise ValueError(f"superleaf {name} has {t.shape[0]} rows, not "
                             f"{BLOCK_ROWS} for each of {n_blocks} blocks")


def check_lane_records(tables, device, n_blocks):
    """The tables of ``n_blocks`` superleaf blocks (:func:`check_block_tables`)
    and their lane records (``tables.lanes``, derived on ``device`` at
    first use) as the kernels read them; returns the records."""
    check_block_tables(tables, device, n_blocks)
    lanes = tables.lanes
    _check_aligned("superleaf lane records", lanes.records, device,
                   LANE_RECORD)
    off = lanes.offsets
    if (off.device != device or off.dtype != torch.int32
            or off.shape != (n_blocks + 1,) or not off.is_contiguous()):
        raise ValueError(f"superleaf lane offsets must be contiguous int32 "
                         f"({n_blocks + 1},) on {device}")
    return lanes


def check_group_bounds(tree, device):
    """The group boxes of a superleaf tree (``tree.groups``, derived on
    ``device`` at first use) as #2b reads them; returns them."""
    groups = tree.groups
    _check_aligned("superleaf group boxes", groups, device, 4)
    if groups.shape[0] != tree.n_blocks * GROUPS * 2:
        raise ValueError(f"superleaf group boxes have {groups.shape[0]} "
                         f"rows, not {GROUPS * 2} for each of "
                         f"{tree.n_blocks} blocks")
    return groups


def _mxu_tree_args(tree, device):
    """#2b's tree arguments (pairs, lane records, offsets, payload, group
    boxes, root), checked."""
    _check_aligned("superleaf pairs", tree.pairs, device, 16)
    _check_root(tree)
    lanes = check_lane_records(tree, device, tree.n_blocks)
    groups = check_group_bounds(tree, device)
    return (tree.pairs.data_ptr(), lanes.records.data_ptr(),
            lanes.offsets.data_ptr(), tree.coeff_pay.data_ptr(),
            groups.data_ptr(), tree.root)


#: #2b's tree argument types (:func:`_mxu_tree_args`)
_MXU_TREE = (_VP, _VP, _VP, _VP, _VP, _I)


def launch_render(what, library, symbol, tree_argtypes, tree_args, scene,
                  camera, *, width, height, spp, max_depth, seed,
                  inclusive_uv, rows=None, normalize=True):
    """Pack and check the camera, sphere and material tables of ``scene``
    on its CUDA device and launch the mesh render entry ``symbol`` of
    ``csrc/<library>.cu`` with the (already checked) tree arguments
    ``tree_args``: returns the flat (H*W, 3) output, each pixel's mean
    (with ``normalize=False`` its sum).  ``rows`` = (n_rows, row_start,
    sample_offset) goes to an entry that takes a shard's rows and samples
    (kernel #2's), whose output is (n_rows*W, 3)."""
    device = scene.device
    mk._check_launch_args(device, width, height, spp, max_depth, what)
    if rows is not None:
        check_rows(height, rows)
    with torch.no_grad():
        cam = mk.pack_camera(camera).contiguous()
        sph = mk.pack_scene(scene).contiguous()
        mat = pack_materials(scene.materials).contiguous()
    mk._check_table("camera table", cam, device, mk.N_CAM_FIELDS)
    mk._check_table("sphere table", sph, device, mk.N_SPHERE_FIELDS)
    mk._check_table("material table", mat, device, N_MAT_FIELDS)
    mk._check_smem(cam, sph, mat)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    n_rows = height if rows is None else rows[0]
    out = torch.empty((n_rows * width, 3), dtype=torch.float32, device=device)
    fn = _build.entry(library, symbol, _RENDER_HEAD + tuple(tree_argtypes)
                      + (_RENDER_TAIL if rows is None else _ROWS_TAIL))
    film = (width, height) if rows is None else (width, *rows)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            cam.data_ptr(), sph.data_ptr(), sph.shape[0], mat.data_ptr(),
            mat.shape[0], *tree_args, out.data_ptr(), *film, spp,
            max_depth, seed & 0xFFFFFFFF, du, dv,
            mk._inv_spp(spp) if normalize else 1.0,
            int(camera.has_lens), stream,
        )
    mk._launch_error(what, err)
    return out


def render_flat_bvh_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    mxu_leaf: bool = False,
):
    """Packed-BVH render → flat (H*W, 3) bottom-up HDR buffer.

    Requires ``scene.packed`` (:func:`spira_tpu_torch.accel.pairs.
    attach_packed`).  A scene on a CUDA device launches the CUDA kernel
    (built on first use) and adds one to
    ``render_flat_bvh_megakernel.launches``; a scene on the CPU runs
    :func:`render_flat_bvh_fused`.  Same PCG stream as the sphere
    megakernel.  Any other device, and any input the kernel does not
    take, raises.  ``mxu_leaf`` walks the superleaf tree on
    ``scene.wide`` instead: :func:`render_flat_bvh_mxu_megakernel`.
    """
    if mxu_leaf:
        return render_flat_bvh_mxu_megakernel(
            scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv)
    if scene.device.type == "cpu":
        return render_flat_bvh_fused(scene, camera, **kw)
    return _launch_bvh(scene, camera, **kw)


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_flat_bvh_megakernel.launches = 0


def _launch_bvh(scene, camera, *, mxu_leaf=False, rows=None, normalize=True,
                **kw):
    """Launch kernel #2 (``spira_bvh_megakernel_render``) or, with
    ``mxu_leaf``, its superleaf form (``spira_bvh_mxu_render``) on the
    scene's CUDA device, over ``rows`` (:func:`launch_render`), and add one
    to ``render_flat_bvh_megakernel.launches`` or
    ``render_flat_bvh_mxu_megakernel.launches``."""
    tree = _require_tree(scene, mxu_leaf)
    if mxu_leaf:
        out = launch_render(
            "bvh_mxu_megakernel", "bvh_megakernel", "spira_bvh_mxu_render",
            _MXU_TREE, _mxu_tree_args(tree, scene.device), scene, camera,
            rows=rows or (kw["height"], 0, 0), normalize=normalize, **kw)
        render_flat_bvh_mxu_megakernel.launches += 1
        return out
    _check_tree_tables(tree, scene.device)
    with annotate("spira.kernel.render_flat_bvh_megakernel"):
        out = launch_render(
            "bvh_megakernel", "bvh_megakernel", "spira_bvh_megakernel_render",
            (_VP, _VP, _I, _I),  # pairs, tri_rows, root, form_bw
            (tree.pairs.data_ptr(), tree.tri_rows.data_ptr(), tree.root,
             int(tree.form == "bw")), scene, camera,
            rows=rows or (kw["height"], 0, 0), normalize=normalize, **kw)
    render_flat_bvh_megakernel.launches += 1
    return out


def bvh_rows(scene, camera, *, width: int, height: int, n_rows: int,
             row_start: int, sample_offset: int, spp: int, max_depth: int,
             seed: int, inclusive_uv: bool = True, mxu_leaf: bool = False):
    """The packed-BVH path tracer over a range of rows and samples, the
    shard body of the tile- and sample-sharded mesh renderer
    (:mod:`spira_tpu_torch.parallel.sharded`): the **sum** over samples
    ``sample_offset .. sample_offset + spp - 1`` of the ``n_rows`` rows
    from ``row_start`` (counted from the bottom) of a ``width`` x
    ``height`` frame, (n_rows*width, 3).

    The counterpart of JAX's ``bvh_rows``
    (``spira_tpu/kernels/bvh_megakernel.py:1399``), less its TPU knobs.
    PCG keys on the global pixel and sample, so the shards of a frame sum
    to the frame: with the samples unsplit and a power-of-two ``spp``, the
    shards' sums over ``spp`` are :func:`render_flat_bvh_megakernel`'s
    image to the bit.  A scene on a CUDA device launches kernel #2 once
    (with ``mxu_leaf`` its superleaf form over ``scene.wide``) and counts
    it as :func:`render_flat_bvh_megakernel` (or
    :func:`render_flat_bvh_mxu_megakernel`) does; a scene on the CPU runs
    :func:`render_flat_bvh_fused` over the same rows.
    """
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv, mxu_leaf=mxu_leaf,
              rows=(n_rows, row_start, sample_offset), normalize=False)
    if scene.device.type == "cpu":
        return render_flat_bvh_fused(scene, camera, **kw)
    return _launch_bvh(scene, camera, **kw)


def render_bvh_with_counters(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    mxu_leaf: bool = False,
):
    """The packed-BVH render and its work counters: (flat (H*W, 3)
    bottom-up HDR buffer, {counter: total over the frame}), the
    counterpart of the JAX ``render_bvh_with_counters``.

    The counters (:data:`COUNTERS`) are per ray where JAX's are per TPU
    packet: ``pops`` (records popped), ``pushes`` (internal children
    pushed), ``traversals`` (walks entered: one per live path segment),
    ``leaf_visits`` (leaf children visited), ``leaf_tris`` (leaf triangles
    tested), ``leaf_visits_primary`` (leaf visits at bounce 0) and
    ``hits`` (segments whose nearest hit is a surface).  Every popped
    record is the root or was pushed: ``pops == traversals + pushes``.
    JAX's ``pop_batches``, ``leaf_blocks_run``/``leaf_blocks_total`` and
    ``leaf_retests_culled`` count the K-pop packet batch, ``leaf_gate``
    and ``defer_leaves``, TPU knobs that are not ported, and are left out.

    A scene on a CUDA device launches the counting build of kernel #2
    (``spira_bvh_megakernel_render_counted``: the same image as
    :func:`render_flat_bvh_megakernel` on the same seed) and adds one to
    ``render_bvh_with_counters.launches``; a scene on the CPU runs
    :func:`render_bvh_counters_fused`.  ``mxu_leaf`` counts kernel #2b
    over the superleaf tree on ``scene.wide`` instead
    (``spira_bvh_mxu_render_counted``, the image of
    :func:`render_flat_bvh_mxu_megakernel`): ``leaf_visits`` are the
    blocks visited and ``leaf_tris`` their real lanes, all of which it
    tests.
    """
    packed = _require_tree(scene, mxu_leaf)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv)
    if scene.device.type == "cpu":
        flat, counts = render_bvh_counters_fused(scene, camera,
                                                 mxu_leaf=mxu_leaf, **kw)
        return flat, {k: int(v.sum()) for k, v in counts.items()}
    totals = torch.zeros(len(COUNTERS), dtype=torch.int64,
                         device=scene.device)
    if mxu_leaf:
        out = launch_render(
            "bvh_mxu_megakernel_counted", "bvh_megakernel",
            "spira_bvh_mxu_render_counted", _MXU_TREE + (_VP,),  # totals
            _mxu_tree_args(packed, scene.device) + (totals.data_ptr(),),
            scene, camera, **kw)
        render_bvh_with_counters.launches += 1
        return out, dict(zip(COUNTERS, totals.tolist()))
    _check_tree_tables(packed, scene.device)
    out = launch_render(
        "bvh_megakernel_counted", "bvh_megakernel",
        "spira_bvh_megakernel_render_counted",
        (_VP, _VP, _I, _I, _VP),  # pairs, tri_rows, root, form_bw, totals
        (packed.pairs.data_ptr(), packed.tri_rows.data_ptr(), packed.root,
         int(packed.form == "bw"), totals.data_ptr()), scene, camera, **kw)
    render_bvh_with_counters.launches += 1
    return out, dict(zip(COUNTERS, totals.tolist()))


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_bvh_with_counters.launches = 0


def render_flat_bvh_mxu_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Packed-BVH render whose leaves are superleaf blocks → flat (H*W, 3)
    bottom-up HDR buffer: the counterpart of the JAX packet kernel with
    ``mxu_leaf=True``.

    Requires a :class:`~spira_tpu_torch.accel.mxu.SuperleafBVH` on
    ``scene.wide`` (:func:`spira_tpu_torch.accel.mxu.attach_superleaf`).
    A scene on a CUDA device launches ``spira_bvh_mxu_render`` (kernel
    #2b: the walk of kernel #2, each block visit served by the whole warp
    and skipping the lane groups whose box the ray does not enter before
    its best, ``csrc/superleaf.cuh:walk_blocks_warp``, over the tree's
    ``lanes`` and ``groups``) and adds one to
    ``render_flat_bvh_mxu_megakernel.launches``; a scene on the CPU runs
    :func:`render_flat_bvh_fused` with ``mxu_leaf=True``.  The fp32
    result is the JAX kernel's ``mxu_precision="highest"``; that TPU knob
    is not taken.
    """
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv, mxu_leaf=True)
    if scene.device.type == "cpu":
        return render_flat_bvh_fused(scene, camera, **kw)
    return _launch_bvh(scene, camera, **kw)


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_flat_bvh_mxu_megakernel.launches = 0


def intersect_tile(packed, origins, dirs, *, active=None, with_slot=False):
    """Nearest hit of (N, 3) rays over the packed tables: (t (N,),
    normal (N, 3), mat id (N,) int32[, slot (N,) int32]), with t = 1e20,
    normal 0, mat id -1 and slot -1 on a miss.  ``active``: optional (N,)
    mask, nonzero for a live ray (bool, as the wavefront hands it, goes
    to the kernel as it is); inactive rays miss.

    Rays on a CUDA device launch the CUDA kernel and add one to
    ``intersect_tile.launches``; rays on the CPU run
    :func:`intersect_packed_plain`.
    """
    device = origins.device
    if device.type == "cpu":
        return intersect_packed_plain(packed, origins, dirs, active,
                                      with_slot)
    if device.type != "cuda":
        raise ValueError(f"intersect_tile runs on cuda or cpu, not {device}")
    _check_packed(packed)
    _check_tree_tables(packed, device)
    n = origins.shape[0]
    for name, t in (("origins", origins), ("dirs", dirs)):
        mk._check_table(name, t, device, 3)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rays, origins {n}")
    act = None
    if active is not None:
        act = active.to(torch.bool).contiguous()
        if act.device != device or act.shape != (n,):
            raise ValueError(f"active must be ({n},) on {device}")
    t = torch.empty(n, dtype=torch.float32, device=device)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=device)
    mid = torch.empty(n, dtype=torch.int32, device=device)
    slot = torch.empty(n, dtype=torch.int32, device=device) if with_slot \
        else None
    fn = _build.entry("bvh_megakernel", "spira_bvh_intersect",
                      _INTERSECT_ARGTYPES)
    with annotate("spira.kernel.intersect_tile"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            origins.data_ptr(), dirs.data_ptr(),
            act.data_ptr() if act is not None else None, n,
            packed.pairs.data_ptr(), packed.tri_rows.data_ptr(), packed.root,
            int(packed.form == "bw"), t.data_ptr(), nrm.data_ptr(),
            mid.data_ptr(), slot.data_ptr() if with_slot else None, stream,
        )
    mk._launch_error("bvh_intersect", err)
    intersect_tile.launches += 1
    return (t, nrm, mid, slot) if with_slot else (t, nrm, mid)


#: Kernel launches since the count was last reset (set it to 0 to reset).
intersect_tile.launches = 0


def make_sorted_tile_intersect(*, grad: bool = False, query=None):
    """The wavefront estimator's nearest-hit hook over ``scene.packed``:
    ``intersect(scene, o, d, alive) -> Hit``, for
    :func:`spira_tpu_torch.integrator.path_trace.trace`'s
    ``intersect_fn``.  The counterpart of the JAX
    ``make_sorted_tile_intersect`` (``spira_tpu/kernels/
    bvh_megakernel.py:1631``), which hands each bounce's rays to Pallas
    kernel #3; this one hands them to :func:`intersect_tile`, CUDA kernel
    #3 for rays on the card and its plain version for rays on the CPU.
    ``query`` replaces :func:`intersect_tile` (for example with
    :func:`intersect_packed_plain`, the plain version on any device).

    ``alive`` goes in as the kernel's ``active``: dead rays cost it
    nothing and miss.  The rays are not sorted.  JAX sorts them by (dead,
    direction octant) so that a TPU packet's rays cull together; on the
    card each ray walks the tree on its own, a per-ray walk's nearest hit
    does not depend on the rays' order, and compacting the live rays or
    grouping them by octant made the kernel slower (``PERF.md``).

    ``grad=False``: the hit takes the kernel's own t, normal and
    material.  ``grad=True``: the kernel also reports the winner's
    triangle slot, which ``PackedBVH.prim_map`` maps to the scene's
    triangle; its hit is recomputed by Möller–Trumbore from the scene's
    tables (:func:`spira_tpu_torch.accel.traverse._winner_triangle_hit`),
    so gradients can flow to the camera and the geometry while the walk
    stays a discrete choice.  Both forms merge the triangle hit with the
    spheres' (:func:`intersect_spheres`).
    """
    query = intersect_tile if query is None else query

    def intersect(scene, o, d, alive):
        packed = scene.packed
        if packed is None:
            raise ValueError("the packed-BVH hook needs scene.packed; call "
                             "spira_tpu_torch.accel.pairs.attach_packed")
        o_k = o.detach().contiguous()
        d_k = d.detach().contiguous()
        if grad:
            if packed.prim_map is None:
                raise ValueError("grad=True needs PackedBVH.prim_map (slot "
                                 "-> scene triangle); re-pack the scene "
                                 "with attach_packed")
            t, _, _, slot = query(packed, o_k, d_k, active=alive,
                                  with_slot=True)
            found = (t < 1e19) & (slot >= 0)
            prim = torch.clamp(packed.prim_map[torch.clamp(
                slot.long(), 0, packed.prim_map.shape[0] - 1)].long(), min=0)
            tri = _winner_triangle_hit(scene.triangles, prim, found, o, d)
        else:
            t, nrm, mid = query(packed, o_k, d_k, active=alive)
            found = t < 1e19
            tri = Hit(t=torch.where(found, t, INF), normal=nrm,
                      material=torch.clamp(mid.long(), min=0), hit=found)
        return merge_hits(intersect_spheres(scene.spheres, o, d), tri)

    return intersect
