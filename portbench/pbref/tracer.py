"""The path tracer of the port's kernels #1 and #2, as plain tensor
operations over a batch of (pixel, sample) lanes.

Frozen copy of ``spira_tpu_torch/kernels/megakernel.py:trace_tile`` at
commit 86df806 (sphere loop, shading, PCG4D draws, Russian roulette),
with the sample index a per-lane tensor, so that every sample of a set
of pixels runs as one batch, and with the triangles' nearest hit from the
reference's own tree (:mod:`pbref.bvh`).  The samples of a pixel are
summed in sample order and scaled by float32(1 / spp), as the kernels
fold them.  Every tensor takes the precision of the scene's; with
``bfloat16`` this is the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bvh, pcg
from .vec import INF, SCATTER_EPS, T_MIN

_S_LOBE, _S_FUZZ, _S_GLASS = 1, 2, 3
_N_STREAMS = 3
RR_START = 3
RR_CAP = 0.95
CUTOFF = 0.01
_MAT_KEYS = ("ar", "ag", "ab", "er", "eg", "eb", "metal", "rough", "ior",
             "trans")


def _norm3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def true_divide(x, d: float):
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def sphere_rows(scene):
    """Per-sphere scalar tuples: centre, radius and the material fields
    gathered through the sphere's material (differentiable in them)."""
    m = scene.materials
    k = scene.sphere_mat
    cols = [scene.centers, scene.radii[:, None], m["albedo"][k],
            m["emission"][k], m["metallic"][k][:, None],
            m["roughness"][k][:, None], m["ior"][k][:, None],
            m["transmission"][k][:, None]]
    table = torch.cat(cols, dim=1)
    return [tuple(table[i, f] for f in range(14))
            for i in range(table.shape[0])]


def _material_rows(scene):
    """(M, 10) material table: albedo, emission, metallic, roughness,
    ior, transmission."""
    m = scene.materials
    return torch.cat([m["albedo"], m["emission"], m["metallic"][:, None],
                      m["roughness"][:, None], m["ior"][:, None],
                      m["transmission"][:, None]], dim=1)


class Counts:
    """The work a trace did: live path segments and their hits."""

    def __init__(self):
        self.segments = 0
        self.hits = 0


def make_intersect(scene, counts=None):
    """``intersect(o3, d3, alive) -> (hit, p3, n3, mats10)``: the sphere
    loop seeds the nearest distance, the tree walk beats it."""
    spheres = sphere_rows(scene)
    mat_rows = _material_rows(scene)

    def intersect(o3, d3, alive):
        ox, oy, oz = o3
        dx, dy, dz = d3
        best = torch.full_like(dx, INF)
        st = {k: torch.zeros_like(dx) for k in
              ("ncx", "ncy", "ncz", "inv_r", "tnx", "tny", "tnz",
               *_MAT_KEYS)}
        st["ior"] = torch.ones_like(dx)
        is_tri = torch.zeros_like(dx, dtype=torch.bool)
        for sph in spheres:
            cx, cy, cz, r, *mats = sph[:14]
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
            c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - c
            disc_ok = disc > 0.0
            sqrtd = torch.where(
                disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0)
            root0 = -half_b - sqrtd
            root1 = -half_b + sqrtd
            root = torch.where(root0 > T_MIN, root0, root1)
            hit_k = disc_ok & (root > T_MIN) & (root < best)
            best = torch.where(hit_k, root, best)
            st["ncx"] = torch.where(hit_k, cx, st["ncx"])
            st["ncy"] = torch.where(hit_k, cy, st["ncy"])
            st["ncz"] = torch.where(hit_k, cz, st["ncz"])
            st["inv_r"] = torch.where(hit_k, 1.0 / r, st["inv_r"])
            for key, val in zip(_MAT_KEYS, mats):
                st[key] = torch.where(hit_k, val, st[key])
            is_tri = is_tri & ~hit_k
        if scene.tris:
            t, prim = bvh.nearest(scene.bvh, torch.stack(o3, -1),
                                  torch.stack(d3, -1), best, alive)
            tri = prim >= 0
            best = torch.where(tri, t.to(best.dtype), best)
            is_tri = tri
            p = prim.clamp(min=0)
            nrm = scene.tris["normal"][p]
            st["tnx"], st["tny"], st["tnz"] = nrm.unbind(-1)
            rows = mat_rows[scene.tris["material"][p]]
            for k, key in enumerate(_MAT_KEYS):
                st[key] = torch.where(tri, rows[:, k], st[key])
        hit = best < INF
        if counts is not None:
            counts.segments += int(alive.sum())
            counts.hits += int((alive & hit).sum())
        t_safe = torch.where(hit, best, 1.0)
        px, py, pz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
        nx = (px - st["ncx"]) * st["inv_r"]
        ny = (py - st["ncy"]) * st["inv_r"]
        nz = (pz - st["ncz"]) * st["inv_r"]
        nx, ny, nz = _norm3(nx, ny, nz)
        nx = torch.where(is_tri, st["tnx"], nx)
        ny = torch.where(is_tri, st["tny"], ny)
        nz = torch.where(is_tri, st["tnz"], nz)
        return hit, (px, py, pz), (nx, ny, nz), tuple(st[k]
                                                      for k in _MAT_KEYS)

    return intersect


def trace_lanes(scene, cam, pixel, sample, *, width, height, max_depth,
                seed, inclusive_uv=True, counts=None):
    """Radiance (r, g, b) of each lane's path: ``pixel`` (row * width +
    col, rows from the bottom) and ``sample`` are int64 tensors."""
    dtype = scene.dtype
    du = float(width - 1 if inclusive_uv else width)
    dv = float(height - 1 if inclusive_uv else height)
    row_f = (pixel // width).to(dtype)
    col_f = (pixel % width).to(dtype)
    ox0, oy0, oz0 = cam.origin.unbind(0)
    llcx, llcy, llcz = cam.llc.unbind(0)
    hx, hy, hz = cam.horizontal.unbind(0)
    vx, vy, vz = cam.vertical.unbind(0)
    intersect = make_intersect(scene, counts)

    def stream_id(b, which):
        return (sample * (max_depth * _N_STREAMS + 1) + b * _N_STREAMS
                + which) & 0xFFFFFFFF

    def draws(b, which):
        return pcg.uniform4(pixel, sample, stream_id(b, which), seed, dtype)

    ju, jv, _, _ = draws(0, 0)
    u = true_divide(col_f + ju, du)
    v = true_divide(row_f + jv, dv)
    dx = llcx + u * hx + v * vx - ox0
    dy = llcy + u * hy + v * vy - oy0
    dz = llcz + u * hz + v * vz - oz0
    dx, dy, dz = _norm3(dx, dy, dz)
    ox = torch.zeros_like(dx) + ox0
    oy = torch.zeros_like(dx) + oy0
    oz = torch.zeros_like(dx) + oz0
    tr, tg, tb = (torch.ones_like(dx) for _ in range(3))
    lr, lg, lb = (torch.zeros_like(dx) for _ in range(3))
    alive = torch.ones_like(dx, dtype=torch.bool)

    for b in range(max_depth):
        hit, (px, py, pz), (nx, ny, nz), mats = intersect(
            (ox, oy, oz), (dx, dy, dz), alive)
        m_ar, m_ag, m_ab, m_er, m_eg, m_eb, m_metal, m_rough, m_ior, \
            m_trans = mats
        t_sky = 0.5 * (dy + 1.0)
        miss = alive & ~hit
        lr = lr + torch.where(miss, tr * (1.0 - t_sky + 0.5 * t_sky), 0.0)
        lg = lg + torch.where(miss, tg * (1.0 - t_sky + 0.7 * t_sky), 0.0)
        lb = lb + torch.where(miss, tb * (1.0 - t_sky + 1.0 * t_sky), 0.0)
        live = alive & hit
        lr = lr + torch.where(live, tr * m_er, 0.0)
        lg = lg + torch.where(live, tg * m_eg, 0.0)
        lb = lb + torch.where(live, tb * m_eb, 0.0)
        nx = torch.where(hit, nx, 0.0)
        ny = torch.where(hit, ny, 1.0)
        nz = torch.where(hit, nz, 0.0)
        entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
        sgn = torch.where(entering, 1.0, -1.0).to(dtype)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        u_lobe, u_rr, u_d1, u_d2 = draws(b, _S_LOBE)
        f1, f2, f3, f4 = draws(b, _S_FUZZ)
        g1, g2 = pcg.box_muller(f1, f2)
        g3, _ = pcg.box_muller(f3, f4)
        u_trans, u_fres, _, _ = draws(b, _S_GLASS)

        d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
        rx = dx - 2.0 * d_dot_n * nx
        ry = dy - 2.0 * d_dot_n * ny
        rz = dz - 2.0 * d_dot_n * nz
        ux, uy, uz = _norm3(g1, g2, g3)
        sx, sy, sz = _norm3(rx + m_rough * ux, ry + m_rough * uy,
                            rz + m_rough * uz)
        eta = torch.where(entering, 1.0 / m_ior, m_ior)
        cos_i = torch.clamp(-d_dot_n, 0.0, 1.0)
        sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
        tir = sin2_t > 1.0
        refracts = sin2_t < 1.0
        cos_t = torch.where(
            refracts, torch.sqrt(torch.where(refracts, 1.0 - sin2_t, 1.0)),
            0.0)
        fx = eta * dx + (eta * cos_i - cos_t) * nx
        fy = eta * dy + (eta * cos_i - cos_t) * ny
        fz = eta * dz + (eta * cos_i - cos_t) * nz
        fx, fy, fz = _norm3(fx, fy, fz)
        q = (1.0 - m_ior) / (1.0 + m_ior)
        r0 = q * q
        one_m = 1.0 - cos_i
        schlick = r0 + (1.0 - r0) * one_m * one_m * one_m * one_m * one_m
        refl_choice = tir | (u_fres < schlick)
        is_glass = u_trans < m_trans
        gx = torch.where(refl_choice, sx, fx)
        gy = torch.where(refl_choice, sy, fy)
        gz = torch.where(refl_choice, sz, fz)
        sx = torch.where(is_glass, gx, sx)
        sy = torch.where(is_glass, gy, sy)
        sz = torch.where(is_glass, gz, sz)

        phi = pcg.TWO_PI_F32 * u_d1
        sq = torch.sqrt(u_d2)
        ddx = torch.cos(phi) * sq
        ddy = torch.sin(phi) * sq
        ddz = torch.sqrt(torch.clamp(1.0 - u_d2, min=0.0))
        pick_y = torch.abs(nx) > 0.1
        ax = torch.where(pick_y, 0.0, 1.0).to(dtype)
        ay = torch.where(pick_y, 1.0, 0.0).to(dtype)
        bux = ay * nz
        buy = -ax * nz
        buz = ax * ny - ay * nx
        bux, buy, buz = _norm3(bux, buy, buz)
        bvx = ny * buz - nz * buy
        bvy = nz * bux - nx * buz
        bvz = nx * buy - ny * bux
        cx_, cy_, cz_ = _norm3(ddx * bux + ddy * bvx + ddz * nx,
                               ddx * buy + ddy * bvy + ddz * ny,
                               ddx * buz + ddy * bvz + ddz * nz)
        spec = u_lobe < m_metal
        ndx = torch.where(spec, sx, cx_)
        ndy = torch.where(spec, sy, cy_)
        ndz = torch.where(spec, sz, cz_)
        ntr, ntg, ntb = tr * m_ar, tg * m_ag, tb * m_ab
        survived = live
        if b > RR_START:
            p_cont = torch.clamp(torch.maximum(ntr, torch.maximum(ntg, ntb)),
                                 1e-6, RR_CAP).detach()
            keep = ~(u_rr > p_cont)
            inv_p = 1.0 / p_cont
            ntr = torch.where(keep, ntr * inv_p, ntr)
            ntg = torch.where(keep, ntg * inv_p, ntg)
            ntb = torch.where(keep, ntb * inv_p, ntb)
            survived = survived & keep
            survived = survived & (
                torch.maximum(ntr, torch.maximum(ntg, ntb)) >= CUTOFF)
        out_side = _dot3(ndx, ndy, ndz, nx, ny, nz) >= 0.0
        osgn = torch.where(out_side, 1.0, -1.0).to(dtype)
        nox = px + SCATTER_EPS * osgn * nx
        noy = py + SCATTER_EPS * osgn * ny
        noz = pz + SCATTER_EPS * osgn * nz
        ox = torch.where(survived, nox, ox)
        oy = torch.where(survived, noy, oy)
        oz = torch.where(survived, noz, oz)
        dx = torch.where(survived, ndx, dx)
        dy = torch.where(survived, ndy, dy)
        dz = torch.where(survived, ndz, dz)
        tr = torch.where(survived, ntr, tr)
        tg = torch.where(survived, ntg, tg)
        tb = torch.where(survived, ntb, tb)
        alive = survived
    return lr, lg, lb


def render_pixels(scene, cam, pixels, *, width, height, spp, max_depth,
                  seeds, lanes=1 << 22, counts=None):
    """Each pixel's mean of ``spp`` samples in the frame of each of
    ``seeds``, (F, P, 3): the samples summed in sample order and scaled
    by float32(1/spp).  ``pixels`` is an int64 tensor of bottom-up flat
    indices; the frames' lanes run together, ``lanes`` bounding a
    batch."""
    n_px, n_fr = pixels.shape[0], len(seeds)
    per = max(1, min(spp, lanes // max(n_px * n_fr, 1)))
    seed_of = torch.as_tensor([int(s) & 0xFFFFFFFF for s in seeds],
                              device=pixels.device)
    acc = None
    for s0 in range(0, spp, per):
        s1 = min(spp, s0 + per)
        k = s1 - s0
        # lanes ordered (frame, sample, pixel)
        pix = pixels.repeat(n_fr * k)
        smp = torch.arange(s0, s1, device=pixels.device).repeat_interleave(
            n_px).repeat(n_fr)
        seed = seed_of.repeat_interleave(k * n_px)
        r, g, b = trace_lanes(scene, cam, pix, smp, width=width,
                              height=height, max_depth=max_depth, seed=seed,
                              counts=counts)
        rgb = torch.stack([r, g, b], -1).reshape(n_fr, k, n_px, 3)
        for j in range(k):
            acc = rgb[:, j] if acc is None else acc + rgb[:, j]
    return acc * float(np.float32(1.0 / spp))
