"""Nearest-hit queries over whole wavefronts of rays.

Counterpart of :mod:`spira_tpu.integrator.intersect`.  A brute-force test
is an elementwise op over an (N rays, P primitives) grid and the nearest
hit a masked min over the primitive axis.  The JAX package selects the
winner with one-hot matrix products, to keep per-lane gathers off the
TPU; here the winner is an ``argmin`` (the first index on ties, as JAX's
``cumsum == 1`` picks it) and a plain gather.  Misses keep JAX's record:
t = ``INF``, material 0.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import tensor_dataclass
from ..core.vecmath import INF, T_MIN


@tensor_dataclass
class Hit:
    """Per-ray nearest-hit record (all (N,) / (N, 3))."""

    t: torch.Tensor
    normal: torch.Tensor  # geometric unit normal (outward, not face-forwarded)
    material: torch.Tensor  # int64 material index (0 where no hit)
    hit: torch.Tensor  # bool


def no_hit(n: int, device) -> Hit:
    return Hit(
        t=torch.full((n,), INF, dtype=torch.float32, device=device),
        normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
        material=torch.zeros((n,), dtype=torch.int64, device=device),
        hit=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def _winner(t, valid):
    """(t_best (N,), hit (N,), index (N,) of the first nearest valid
    primitive) of an (N, P) grid of distances, INF where not valid."""
    t_best, idx = torch.min(torch.where(valid, t, INF), dim=1)
    return t_best, t_best < INF, idx


def intersect_spheres(spheres, origins, directions, t_min=T_MIN,
                      t_max=INF) -> Hit:
    """Nearest sphere hit per ray, brute force over all spheres: the
    half-b quadratic, nearer root first (unit directions)."""
    n = origins.shape[0]
    if spheres.count == 0:
        return no_hit(n, origins.device)
    oc = origins[:, None, :] - spheres.centers[None, :, :]  # (N, S, 3)
    half_b = torch.sum(oc * directions[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - spheres.radii[None, :] ** 2
    disc = half_b * half_b - c
    # double-where guards: sqrt'(0) = inf in masked-off branches would
    # poison the backward pass
    disc_ok = disc > 0.0
    sqrtd = torch.where(disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)),
                        0.0)
    root0 = -half_b - sqrtd
    root1 = -half_b + sqrtd
    root = torch.where(root0 > t_min, root0, root1)
    valid = disc_ok & (root > t_min) & (root < t_max)
    t_best, hit, idx = _winner(root, valid)
    # INF stays in Hit.t (merge_hits relies on it); the normal takes a
    # guarded t, and a miss the center 0, as JAX's empty one-hot row
    t_safe = torch.where(hit, t_best, 1.0)
    center = vm.where(hit, spheres.centers[idx], 0.0)
    p = origins + t_safe[:, None] * directions
    normal = vm.normalize(p - center)
    material = torch.where(hit, spheres.material[idx].long(), 0)
    return Hit(t=t_best, normal=normal, material=material, hit=hit)


def intersect_triangles(tris, origins, directions, t_min=T_MIN,
                        t_max=INF) -> Hit:
    """Nearest triangle hit per ray: Möller–Trumbore brute force over all
    T triangles, an (N, T) grid (meshes take a BVH)."""
    n = origins.shape[0]
    if tris.count == 0:
        return no_hit(n, origins.device)
    t, u, v, det = _moller_trumbore(tris, origins, directions)
    valid = ((torch.abs(det) > 1e-9) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    t_best, hit, idx = _winner(t, valid)
    normal = vm.where(hit, tris.normal[idx], 0.0)
    material = torch.where(hit, tris.material[idx].long(), 0)
    return Hit(t=t_best, normal=normal, material=material, hit=hit)


def _moller_trumbore(tris, origins, directions):
    """Raw Möller–Trumbore terms over (N rays, T tris): t, u, v, det."""
    d = directions[:, None, :]  # (N, 1, 3)
    e1 = tris.e1[None, :, :]  # (1, T, 3)
    e2 = tris.e2[None, :, :]
    pvec = vm.cross(d, e2)  # (N, T, 3)
    det = torch.sum(e1 * pvec, dim=-1)  # (N, T)
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = origins[:, None, :] - tris.v0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = vm.cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    return t, u, v, det


def merge_hits(a: Hit, b: Hit) -> Hit:
    """Nearest of two hit records (``a`` on ties)."""
    take_b = b.t < a.t
    return Hit(
        t=torch.where(take_b, b.t, a.t),
        normal=vm.where(take_b, b.normal, a.normal),
        material=torch.where(take_b, b.material, a.material),
        hit=a.hit | b.hit,
    )


def intersect_scene(scene, origins, directions, t_min=T_MIN) -> Hit:
    """Nearest hit against everything in the scene.

    A mixed sphere+triangle tree (``bvh.n_sph > 0``,
    :func:`spira_tpu_torch.accel.bvh.build_mixed_bvh`) resolves everything
    in one traversal.  Otherwise spheres are brute force and triangles go
    through the stackless walk of ``scene.bvh`` when it is set, else brute
    force.
    """
    from ..accel.traverse import intersect_bvh, intersect_bvh_mixed

    if scene.bvh is not None and scene.bvh.n_sph > 0:
        return intersect_bvh_mixed(scene.bvh, scene.spheres, scene.triangles,
                                   origins, directions, t_min)
    hit = intersect_spheres(scene.spheres, origins, directions, t_min)
    if scene.bvh is not None:
        tri_hit = intersect_bvh(scene.bvh, scene.triangles, origins,
                                directions, t_min)
        hit = merge_hits(hit, tri_hit)
    elif scene.triangles.count > 0:
        tri_hit = intersect_triangles(scene.triangles, origins, directions,
                                      t_min)
        hit = merge_hits(hit, tri_hit)
    return hit
