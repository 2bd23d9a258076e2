"""BVH traversal over a ray wavefront as masked tensor loops.

Counterpart of :mod:`spira_tpu.accel.traverse`, which is XLA code and no
Pallas kernel.  This is its plain port, not the card's mesh path: on the
card a packed scene takes its nearest hits from CUDA kernel #3
(:func:`spira_tpu_torch.kernels.bvh_megakernel.make_sorted_tile_intersect`).

* :func:`intersect_bvh` — the stackless state machine (parent and sibling
  links, enter/leave states): every ray takes one node a step, all rays
  in lockstep, dead lanes masked.
* :func:`intersect_bvh_mixed` — the same walk over a tree whose leaves
  hold spheres and triangles (:func:`spira_tpu_torch.accel.bvh.
  build_mixed_bvh`).
* :func:`intersect_bvh_stack` — the stack-per-ray form, a testing oracle
  for the stackless walk.

The JAX ``while_loop`` checks whether any ray is still walking every
``chunk = 8`` steps, under a cap of ``4 * node_count + 64`` steps; so do
the stackless walks here.  In torch each check is one host sync.  The
walks run without gradients, on detached rays; the returned hit is
recomputed differentiably against the winner (:func:`_winner_triangle_hit`).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.vecmath import INF, T_MIN
from ..integrator.intersect import Hit
from .bvh import MAX_STACK

#: traversal steps between two checks of the loop condition
CHUNK = 8


def _slab_test(node_min, node_max, origins, inv_dir, t_max):
    """Branchless AABB slab test.  All args (N, 3) / (N,); returns (N,)
    bool."""
    t0 = (node_min - origins) * inv_dir
    t1 = (node_max - origins) * inv_dir
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    tmin = torch.clamp(torch.amax(tsmall, dim=-1), min=0.0)
    tmax = torch.minimum(torch.amin(tbig, dim=-1), t_max)
    return tmin <= tmax


def _safe_inv(directions):
    return torch.where(torch.abs(directions) > 1e-12, 1.0 / directions, 1e12)


def _winner_triangle_hit(tris, best_prim, found, origins, directions) -> Hit:
    """Differentiable hit record against an already selected triangle:
    t by Möller–Trumbore from one gather, so camera and geometry
    gradients flow through the recompute while the walk that chose the
    winner stays a discrete choice."""
    v0 = tris.v0[best_prim]
    e1 = tris.e1[best_prim]
    e2 = tris.e2[best_prim]
    pvec = vm.cross(directions, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = origins - v0
    qvec = vm.cross(tvec, e1)
    tt = torch.sum(e2 * qvec, dim=-1) * inv_det
    return Hit(
        t=torch.where(found, tt, INF),
        normal=tris.normal[best_prim],
        material=tris.material[best_prim].long(),
        hit=found,
    )


def _mt_leaf(td, origins, directions):
    """Möller–Trumbore of each ray against its own triangle row
    ``td`` (N, 9): (t, valid without the t bounds)."""
    v0, e1, e2 = td[:, 0:3], td[:, 3:6], td[:, 6:9]
    pvec = vm.cross(directions, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = origins - v0
    uu = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = vm.cross(tvec, e1)
    vv = torch.sum(directions * qvec, dim=-1) * inv_det
    tt = torch.sum(e2 * qvec, dim=-1) * inv_det
    return tt, det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)


def _node_tables(bvh):
    nodes_f = torch.cat([bvh.node_min, bvh.node_max], dim=1)  # (M, 6)
    nodes_i = torch.stack([bvh.left, bvh.right, bvh.is_leaf, bvh.parent,
                           bvh.sibling, bvh.is_left], dim=1).long()  # (M, 6)
    return nodes_f, nodes_i


def _stackless_walk(bvh, origins, directions, leaf_test):
    """The stackless walk of every ray: (best_t, best_prim).

    ``leaf_test(prim) -> (t, valid)`` tests each ray against its
    primitive id ``prim`` (N,)."""
    nodes_f, nodes_i = _node_tables(bvh)
    inv_dir = _safe_inv(directions)
    n = origins.shape[0]
    dev = origins.device
    n_slots = bvh.prim_idx.shape[0]
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    entering = torch.ones(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_prim = torch.zeros(n, dtype=torch.int64, device=dev)
    max_iters = 4 * bvh.node_count + 64  # safety bound
    it = 0
    while it < max_iters and not bool(done.all()):
        for _ in range(CHUNK):
            nf, ni = nodes_f[cur], nodes_i[cur]
            left, right, parent, sibling = (ni[:, 0], ni[:, 1], ni[:, 3],
                                            ni[:, 4])
            is_leaf = ni[:, 2] == 1
            is_left = ni[:, 5] == 1
            box_hit = _slab_test(nf[:, 0:3], nf[:, 3:6], origins, inv_dir,
                                 best_t) & entering & ~done
            leaf_proc = box_hit & is_leaf
            for j in range(bvh.max_leaf):
                slot = torch.clamp(left + j, 0, max(n_slots - 1, 0))
                prim = bvh.prim_idx[slot].long()
                tt, valid = leaf_test(prim)
                closer = leaf_proc & (j < right) & valid & (tt < best_t)
                best_t = torch.where(closer, tt, best_t)
                best_prim = torch.where(closer, prim, best_prim)
            # transitions of the state machine
            descend = box_hit & ~is_leaf
            has_sib = is_left & (sibling >= 0)
            up_next = torch.where(has_sib, sibling, parent)
            new_done = done | (~descend & ~done & (cur == 0))
            next_cur = torch.where(descend, left, up_next)
            cur = torch.where(new_done, 0, torch.clamp(next_cur, min=0))
            entering = descend | (~descend & has_sib)
            done = new_done
        it += CHUNK
    return best_t, best_prim


def intersect_bvh(bvh, tris, origins, directions, t_min=T_MIN) -> Hit:
    """Stackless nearest-hit traversal over triangles."""
    o, d = origins.detach(), directions.detach()
    with torch.no_grad():
        tris9 = torch.cat([tris.v0, tris.e1, tris.e2], dim=1)  # (T, 9)

        def leaf_test(prim):
            tt, valid = _mt_leaf(tris9[prim], o, d)
            return tt, valid & (tt > t_min)

        best_t, best_prim = _stackless_walk(bvh, o, d, leaf_test)
    return _winner_triangle_hit(tris, best_prim, best_t < INF, origins,
                                directions)


def intersect_bvh_mixed(bvh, spheres, tris, origins, directions,
                        t_min=T_MIN) -> Hit:
    """Stackless traversal over a mixed sphere+triangle tree: primitive
    ids below ``bvh.n_sph`` are spheres, the rest triangles (id -
    n_sph).  Each leaf slot gathers one sphere row and one triangle row
    and takes the test of its primitive's kind."""
    n_sph = bvh.n_sph
    n_tris = tris.count if tris is not None else 0
    o, d = origins.detach(), directions.detach()
    with torch.no_grad():
        sph4 = torch.cat([spheres.centers, spheres.radii[:, None]], dim=1)
        tris9 = (torch.cat([tris.v0, tris.e1, tris.e2], dim=1)
                 if n_tris else None)

        def leaf_test(prim):
            is_s = prim < n_sph
            sd = sph4[torch.clamp(prim, 0, max(n_sph - 1, 0))]
            oc = o - sd[:, 0:3]
            half_b = torch.sum(oc * d, dim=-1)
            c = torch.sum(oc * oc, dim=-1) - sd[:, 3] * sd[:, 3]
            disc = half_b * half_b - c
            disc_ok = disc > 0.0
            sqrtd = torch.sqrt(torch.where(disc_ok, disc, 0.0))
            root0 = -half_b - sqrtd
            root1 = -half_b + sqrtd
            t_s = torch.where(root0 > t_min, root0, root1)
            valid_s = disc_ok & (t_s > t_min)
            if not n_tris:
                return t_s, valid_s
            t_t, valid_t = _mt_leaf(
                tris9[torch.clamp(prim - n_sph, 0, n_tris - 1)], o, d)
            valid_t = valid_t & (t_t > t_min)
            return (torch.where(is_s, t_s, t_t),
                    torch.where(is_s, valid_s, valid_t))

        best_t, best_prim = _stackless_walk(bvh, o, d, leaf_test)

    # the differentiable recompute against the winner
    hit = best_t < INF
    is_s = best_prim < n_sph
    sp = torch.clamp(best_prim, 0, max(n_sph - 1, 0))
    center = spheres.centers[sp]
    oc = origins - center
    half_b = torch.sum(oc * directions, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - spheres.radii[sp] ** 2
    disc = half_b * half_b - c
    # sqrt at 0 has an infinite derivative: guard the unselected lanes
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    root0 = -half_b - sqrtd
    root1 = -half_b + sqrtd
    t_s = torch.where(root0 > t_min, root0, root1)
    t_safe = torch.where(hit & is_s, t_s, 1.0)
    p = origins + t_safe[:, None] * directions
    sph_n = vm.normalize(p - center)
    sph_mat = spheres.material[sp].long()
    if not n_tris:
        return Hit(t=torch.where(hit, t_s, INF), normal=sph_n,
                   material=sph_mat, hit=hit)
    tri = _winner_triangle_hit(tris,
                               torch.clamp(best_prim - n_sph, 0, n_tris - 1),
                               hit & ~is_s, origins, directions)
    return Hit(
        t=torch.where(is_s, torch.where(hit, t_s, INF), tri.t),
        normal=vm.where(is_s, sph_n, tri.normal),
        material=torch.where(is_s, sph_mat, tri.material),
        hit=hit,
    )


def intersect_bvh_stack(bvh, tris, origins, directions, t_min=T_MIN) -> Hit:
    """Stack-per-ray traversal, the testing oracle of
    :func:`intersect_bvh`: a (N, MAX_STACK + 1) stack whose last column
    takes the masked pushes, popped left child first.  It loops while
    any stack is non-empty."""
    o, d = origins.detach(), directions.detach()
    n = o.shape[0]
    n_prims = tris.count
    with torch.no_grad():
        tris9 = torch.cat([tris.v0, tris.e1, tris.e2], dim=1)
        inv_dir = _safe_inv(d)
        left_all, right_all = bvh.left.long(), bvh.right.long()
        leaf_all = bvh.is_leaf == 1
        stack = torch.zeros((n, MAX_STACK + 1), dtype=torch.int64,
                            device=o.device)
        ptr = torch.ones(n, dtype=torch.int64, device=o.device)
        best_t = torch.full((n,), INF, dtype=torch.float32, device=o.device)
        best_prim = torch.zeros(n, dtype=torch.int64, device=o.device)
        while bool((ptr > 0).any()):
            active = ptr > 0
            top = torch.clamp(ptr - 1, min=0)
            node = stack.gather(1, top[:, None])[:, 0]
            ptr = torch.where(active, ptr - 1, ptr)
            box_hit = _slab_test(bvh.node_min[node], bvh.node_max[node], o,
                                 inv_dir, best_t)
            process = active & box_hit
            node_is_leaf = leaf_all[node]
            leaf = process & node_is_leaf
            first, count = left_all[node], right_all[node]
            for j in range(bvh.max_leaf):
                slot = torch.clamp(first + j, 0, n_prims - 1)
                prim = bvh.prim_idx[slot].long()
                tt, valid = _mt_leaf(tris9[prim], o, d)
                closer = (leaf & (j < count) & valid & (tt > t_min)
                          & (tt < best_t))
                best_t = torch.where(closer, tt, best_t)
                best_prim = torch.where(closer, prim, best_prim)
            # internal: push right then left; a two-level redirect node
            # (left == right) pushes once
            internal = process & ~node_is_leaf
            push_right = internal & (first != count)
            idx = torch.where(push_right, ptr, MAX_STACK)
            stack = stack.scatter(1, idx[:, None], count[:, None])
            ptr = ptr + push_right.long()
            idx = torch.where(internal, ptr, MAX_STACK)
            stack = stack.scatter(1, idx[:, None], first[:, None])
            ptr = ptr + internal.long()
    return _winner_triangle_hit(tris, best_prim, best_t < INF, origins,
                                directions)
