"""The port's wavefront estimator (threefry draws), the estimator whose
vector-Jacobian product is the mesh step's backward.

Frozen copies, at commit 86df806, of ``spira_tpu_torch/scene/camera.py:
generate_rays``, ``integrator/path_trace.py:trace`` (physical semantics),
``integrator/bsdf.py:scatter_physical``, ``integrator/intersect.py:
intersect_spheres``/``merge_hits`` and ``accel/traverse.py:
_winner_triangle_hit``; the nearest triangle comes from the reference's
own tree (:mod:`pbref.bvh`) and its hit is recomputed by Möller–Trumbore
under autograd, as the port recomputes the hit of the triangle its
kernel #3 reports.  Gradients reach the scene's material tensors.
"""

from __future__ import annotations

import math

import torch

from . import bvh, threefry as rng, vec
from .tracer import true_divide
from .vec import INF, SCATTER_EPS, T_MIN

RR_START = 3
RR_CAP = 0.95
CUTOFF = 0.01


def generate_rays(cam, width, height, key):
    dev, dtype = cam.origin.device, cam.origin.dtype
    n = width * height
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    col = (idx % width).to(dtype)
    row = (idx // width).to(dtype)
    jitter = rng.uniform(rng.bounce_key(key, 0, rng.Stream.PIXEL_JITTER),
                         (n, 2), dev, dtype)
    u = true_divide(col + jitter[:, 0], float(width - 1))
    v = true_divide(row + jitter[:, 1], float(height - 1))
    target = (cam.llc[None, :] + u[:, None] * cam.horizontal[None, :]
              + v[:, None] * cam.vertical[None, :])
    disk = rng.uniform(rng.bounce_key(key, 0, rng.Stream.LENS), (n, 2), dev,
                       dtype)
    r = torch.sqrt(disk[:, 0])
    phi = 2.0 * math.pi * disk[:, 1]
    lens_offset = (cam.lens_radius * r)[:, None] * (
        torch.cos(phi)[:, None] * cam.u[None, :]
        + torch.sin(phi)[:, None] * cam.v[None, :])
    origins = cam.origin[None, :] + lens_offset
    return origins, vec.normalize(target - origins)


def _spheres(scene, o, d):
    """Nearest sphere: (t, normal, material, hit)."""
    oc = o[:, None, :] - scene.centers[None, :, :]
    half_b = torch.sum(oc * d[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - scene.radii[None, :] ** 2
    disc = half_b * half_b - c
    disc_ok = disc > 0.0
    sqrtd = torch.where(disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)),
                        0.0)
    root0 = -half_b - sqrtd
    root1 = -half_b + sqrtd
    root = torch.where(root0 > T_MIN, root0, root1)
    valid = disc_ok & (root > T_MIN) & (root < INF)
    t, idx = torch.min(torch.where(valid, root, INF), dim=1)
    hit = t < INF
    t_safe = torch.where(hit, t, 1.0)
    center = vec.where(hit, scene.centers[idx], 0.0)
    normal = vec.normalize(o + t_safe[:, None] * d - center)
    material = torch.where(hit, scene.sphere_mat[idx], 0)
    return t, normal, material, hit


def _triangles(scene, o, d, alive):
    """Nearest triangle through the tree, its t recomputed under autograd
    from the triangle's tables: (t, normal, material, hit)."""
    tris = scene.tris
    best = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    _, prim = bvh.nearest(scene.bvh, o, d, best, alive)
    found = prim >= 0
    p = prim.clamp(min=0)
    v0, e1, e2 = tris["v0"][p], tris["e1"][p], tris["e2"][p]
    pvec = vec.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    qvec = vec.cross(o - v0, e1)
    tt = torch.sum(e2 * qvec, dim=-1) * inv_det
    return (torch.where(found, tt, INF), tris["normal"][p],
            tris["material"][p], found)


def _hit(scene, o, d, alive):
    t, n, m, h = _spheres(scene, o, d)
    if not scene.tris:
        return t, n, m, h
    tt, tn, tm, th = _triangles(scene, o, d, alive)
    take = tt < t
    return (torch.where(take, tt, t), vec.where(take, tn, n),
            torch.where(take, tm, m), h | th)


def _schlick(cos_i, ior):
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    x = 1.0 - cos_i
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def _scatter(skey, b, d_in, normal_out, mat):
    n_rays, dev, dtype = d_in.shape[0], d_in.device, d_in.dtype
    entering = vec.dot(d_in, normal_out) < 0.0
    n_ff = vec.where(entering, normal_out, -normal_out)
    u = rng.uniform(rng.bounce_key(skey, b, rng.Stream.LOBE_SELECT),
                    (n_rays, 3), dev, dtype)
    u_lobe, u_trans, u_fresnel = u[:, 0], u[:, 1], u[:, 2]
    specular_sel = u_lobe < mat["metallic"]
    mirror = vec.normalize(vec.reflect(d_in, n_ff))
    fuzz = rng.unit_vector(rng.bounce_key(skey, b, rng.Stream.METAL_FUZZ),
                           (n_rays,), dev, dtype)
    fuzzed = vec.normalize(mirror + mat["roughness"][:, None] * fuzz)
    eta = torch.where(entering, 1.0 / mat["ior"], mat["ior"])
    refracted, tir = vec.refract(d_in, n_ff, eta[:, None])
    refracted = vec.normalize(refracted)
    cos_i = torch.clamp(-vec.dot(d_in, n_ff), 0.0, 1.0)
    reflect_choice = tir | (u_fresnel < _schlick(cos_i, mat["ior"]))
    glass_dir = vec.where(reflect_choice, fuzzed, refracted)
    is_glass = specular_sel & (u_trans < mat["transmission"])
    spec_dir = vec.where(is_glass, glass_dir, fuzzed)
    diffuse_dir = rng.cosine_hemisphere(
        rng.bounce_key(skey, b, rng.Stream.DIFFUSE_DIR), n_ff)
    return vec.where(specular_sel, spec_dir, diffuse_dir), mat["albedo"]


def _sky(d):
    t = 0.5 * (d[..., 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - t)[..., None] + t[..., None] * blue


def trace(scene, o, d, skey, max_depth):
    """(N, 3) radiance of a wavefront of primary rays drawn from the
    sample's key ``skey``."""
    mats = scene.materials
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for b in range(max_depth):
        t, normal, material, hit = _hit(scene, o, d, alive)
        mat = {k: v[material] for k, v in mats.items()}
        miss = alive & ~hit
        radiance = radiance + torch.where(miss[:, None],
                                          throughput * _sky(d), 0.0)
        live_hit = alive & hit
        t_safe = torch.where(hit, t, 1.0)
        point = o + t_safe[:, None] * d
        radiance = radiance + torch.where(live_hit[:, None],
                                          throughput * mat["emission"], 0.0)
        new_dir, attenuation = _scatter(skey, b, d, normal, mat)
        entering = vec.dot(d, normal) < 0.0
        n_ff = vec.where(entering, normal, -normal)
        going_out = vec.dot(new_dir, n_ff) >= 0.0
        new_origin = point + SCATTER_EPS * vec.where(going_out, n_ff, -n_ff)
        new_tp = throughput * attenuation
        survived = live_hit
        if b > RR_START:
            p_cont = torch.clamp(torch.amax(new_tp, dim=-1), 1e-6,
                                 RR_CAP).detach()
            u_rr = rng.uniform(rng.bounce_key(skey, b, rng.Stream.ROULETTE),
                               (new_tp.shape[0],), o.device, o.dtype)
            kill = u_rr > p_cont
            new_tp = torch.where(~kill[:, None], new_tp / p_cont[:, None],
                                 new_tp)
            survived = survived & ~kill
        survived = survived & (torch.amax(new_tp, dim=-1) >= CUTOFF)
        o = vec.where(survived, new_origin, o)
        d = vec.where(survived, new_dir, d)
        throughput = vec.where(survived, new_tp, throughput)
        alive = survived
    return radiance


def replay_mean(scene, cam, *, width, height, spp, max_depth, seed):
    """The wavefront's mean of ``spp`` samples over the whole frame,
    (H*W, 3) bottom-up, drawn from ``base_key(seed)``: one wavefront a
    sample, in sample order, each gathering its own materials, as the
    port's replay does, so that the gradients' float32 sums run in the
    port's order."""
    base = rng.base_key(seed)
    acc = torch.zeros((width * height, 3), dtype=cam.origin.dtype,
                      device=cam.origin.device)
    for k in range(spp):
        skey = rng.fold_in(rng.sample_key(base, k), 0)
        o, d = generate_rays(cam, width, height, skey)
        acc = acc + trace(scene, o, d, skey, max_depth)
    return true_divide(acc, float(spp))
