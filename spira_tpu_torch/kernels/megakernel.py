"""Fused path-trace megakernel (sphere and small triangle scenes, physical
semantics, RGB): the host side, the plain PyTorch tracer, and the wrapper
of the CUDA kernel.

Counterpart of :mod:`spira_tpu.kernels.megakernel`.  The tracer runs two
ways:

* :func:`render_flat_megakernel` — the hand-written CUDA kernel
  (``csrc/megakernel.cu``), one thread per pixel, for scenes on a CUDA
  device.  For scenes on the CPU it runs the plain version below.
* :func:`render_flat_fused` — :func:`trace_tile`, the same math as
  whole-image tensor ops, component-split (one tensor per x/y/z), with a
  static Python loop over spheres and triangles reading scalars from the
  packed tables.  It runs on any device and is written to be
  differentiable: the double-``where`` guards keep NaN out of the masked-off
  branches' gradients, and the Russian-roulette probability is detached.

:func:`render_flat_hybrid_grad` is the differentiable step: the forward of
:func:`render_flat_megakernel` with, as its backward, the adjoint kernel
of :mod:`.grad_megakernel` (``csrc/grad_megakernel.cu``) on the card, or
autograd through :func:`render_flat_fused` (``remat=True``) on the CPU.

Randomness is the PCG4D counter hash (:mod:`spira_tpu_torch.core.pcg`):
both versions draw the same numbers for the same (pixel, sample, stream,
seed).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import _build
from ..core import pcg

INF = 1e20
T_MIN = 1e-3
SCATTER_EPS = 1e-4
RR_START = 3
RR_CAP = 0.95
CUTOFF = 0.01

# Per-bounce PCG stream ids (stream 0 = ray generation).
_S_LOBE = 1  # lobe select / RR / diffuse disk (4 uniforms)
_S_FUZZ = 2  # metal fuzz normals (4 uniforms -> 3 gaussians)
_S_GLASS = 3  # transmission / fresnel draws
_N_STREAMS = 3

N_SPHERE_FIELDS = 16  # cx cy cz r | albedo3 emission3 metal rough ior trans
N_TRI_FIELDS = 24  # v0(3) e1(3) e2(3) n(3) | albedo3 emission3 metal rough ior trans
N_CAM_FIELDS = 20  # origin llc horizontal vertical u v lens_radius pad
#: the fused engines loop over every primitive for every ray; beyond this
#: many triangles the BVH path is the one to take.
FUSED_TRI_LIMIT = 32
#: the CUDA kernel holds the camera and scene tables in shared memory,
#: which takes 48 KB without an opt-in.
_SMEM_LIMIT = 48 * 1024


def _norm3(x, y, z):
    # 1/sqrt, not torch.rsqrt: on the card rsqrt is approximate, and the
    # CUDA kernel uses the correctly rounded form.
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def true_divide(x, d: float):
    """x / d for a Python number d, rounded as one IEEE division on every
    device, as the kernels divide: on the card torch divides a tensor by a
    Python number as a product with the number's reciprocal, one rounding
    more."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


_select = torch.where


def init_hit_state(dx):
    """Fresh nearest-hit registers for one intersection query."""
    st = {
        k: torch.zeros_like(dx)
        for k in ("ncx", "ncy", "ncz", "inv_r", "m_ar", "m_ag", "m_ab",
                  "m_er", "m_eg", "m_eb", "m_metal", "m_rough", "m_trans",
                  "tnx", "tny", "tnz")
    }
    st["best_t"] = torch.full_like(dx, INF)
    st["m_ior"] = torch.ones_like(dx)
    st["hit_is_tri"] = torch.zeros_like(dx, dtype=torch.bool)
    return st


_MAT_KEYS = ("m_ar", "m_ag", "m_ab", "m_er", "m_eg", "m_eb", "m_metal",
             "m_rough", "m_ior", "m_trans")


def _select_mats(st, mask, fields):
    for key, val in zip(_MAT_KEYS, fields):
        st[key] = _select(mask, val, st[key])


def sphere_unroll(spheres, o3, d3, st):
    """Sphere intersection over a static loop, updating hit state ``st``
    (the dict is mutated and returned)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    for sph in spheres:
        (cx, cy, cz, r, ar, ag, ab_, er, eg, eb, met, rough, ior,
         trans) = sph[:14]
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
        c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
        disc = half_b * half_b - c
        # double-where: sqrt'(0)=inf would poison the backward pass
        # through the masked-off branch
        disc_ok = disc > 0.0
        sqrtd = torch.where(
            disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0
        )
        root0 = -half_b - sqrtd
        root1 = -half_b + sqrtd
        root = _select(root0 > T_MIN, root0, root1)
        hit_k = disc_ok & (root > T_MIN) & (root < best_t)
        best_t = _select(hit_k, root, best_t)
        st["ncx"] = _select(hit_k, cx, st["ncx"])
        st["ncy"] = _select(hit_k, cy, st["ncy"])
        st["ncz"] = _select(hit_k, cz, st["ncz"])
        st["inv_r"] = _select(hit_k, 1.0 / r, st["inv_r"])
        _select_mats(st, hit_k, (ar, ag, ab_, er, eg, eb, met, rough, ior,
                                 trans))
        st["hit_is_tri"] = st["hit_is_tri"] & ~hit_k
    st["best_t"] = best_t
    return st


def tri_unroll(triangles, o3, d3, st):
    """Möller–Trumbore over a static loop of triangles, updating ``st``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    for tri in triangles:
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
         nxc, nyc, nzc, ar, ag, ab_, er, eg, eb, met, rough, ior,
         trans) = tri[:22]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        det_ok = torch.abs(det) > 1e-12
        inv_det = torch.where(
            det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0
        )
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        hit_k = (
            (torch.abs(det) > 1e-9)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > T_MIN)
            & (tt < best_t)
        )
        best_t = _select(hit_k, tt, best_t)
        st["tnx"] = _select(hit_k, nxc, st["tnx"])
        st["tny"] = _select(hit_k, nyc, st["tny"])
        st["tnz"] = _select(hit_k, nzc, st["tnz"])
        st["hit_is_tri"] = st["hit_is_tri"] | hit_k
        _select_mats(st, hit_k, (ar, ag, ab_, er, eg, eb, met, rough, ior,
                                 trans))
    st["best_t"] = best_t
    return st


def finish_intersect(o3, d3, st):
    """Resolve hit state into ``(hit, p3, n3, mats10)``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    hit = best_t < INF
    # miss lanes carry best_t = INF; inf*0 in the untaken branch of a
    # select still NaNs the backward pass — clamp to a safe value.
    best_t = _select(hit, best_t, 1.0)
    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nx = (px - st["ncx"]) * st["inv_r"]
    ny = (py - st["ncy"]) * st["inv_r"]
    nz = (pz - st["ncz"]) * st["inv_r"]
    nx, ny, nz = _norm3(nx, ny, nz)
    nx = _select(st["hit_is_tri"], st["tnx"], nx)
    ny = _select(st["hit_is_tri"], st["tny"], ny)
    nz = _select(st["hit_is_tri"], st["tnz"], nz)
    mats = tuple(st[k] for k in _MAT_KEYS)
    return hit, (px, py, pz), (nx, ny, nz), mats


def make_brute_intersect(spheres, triangles=()):
    """The fused engines' intersector: loops over every primitive.

    Returns ``intersect(o3, d3, active) -> (hit, p3, n3, mats10)`` where
    ``active`` (which lanes carry a live path) is not needed here, p3 is the
    hit point (miss lanes clamped to t=1 so no inf propagates), n3 the unit
    geometric normal (miss lanes arbitrary — the caller masks), and mats10
    the per-lane material fields
    (ar, ag, ab, er, eg, eb, metallic, roughness, ior, transmission).
    """

    def intersect(o3, d3, active=None):
        st = init_hit_state(d3[0])
        st = sphere_unroll(spheres, o3, d3, st)
        st = tri_unroll(triangles, o3, d3, st)
        return finish_intersect(o3, d3, st)

    return intersect


def trace_tile(
    pixel,
    row_f,
    col_f,
    cam,
    spheres,
    triangles=(),
    *,
    seed,
    spp: int,
    max_depth: int,
    du: float,
    dv: float,
    remat: bool = False,
    sample_offset: int = 0,
    intersect_fn=None,
):
    """Trace ``spp`` samples for a batch of pixels; returns summed (r, g, b).

    pixel: int64 PCG counters (row * width + col); row_f/col_f: float pixel
    coordinates (row counted from the image bottom); cam: 12 scalars
    (origin, lower-left corner, horizontal, vertical), or 19 with the
    thin-lens extension (u, v basis, lens radius); spheres: list of
    16-scalar tuples (packed by :func:`pack_scene`); triangles: list of
    24-scalar tuples (packed by :func:`pack_triangles`).

    ``remat=True`` checkpoints each sample
    (``torch.utils.checkpoint``, non-reentrant): autograd keeps only the
    running sums and replays a sample's paths in the backward pass, so the
    backward's memory stays one sample deep.  ``sample_offset`` shifts the
    PCG sample index (samples ``sample_offset .. sample_offset + spp - 1``).

    ``intersect_fn`` (``(o3, d3, active) -> (hit, p3, n3, mats10)``)
    overrides the nearest-hit query, so that other intersectors share the
    shading and scatter math below; ``active`` marks the lanes whose path
    is alive (the others' results are masked, so an intersector may skip
    them).
    """
    (ox0, oy0, oz0, llcx, llcy, llcz, hx, hy, hz, vx, vy, vz) = cam[:12]
    if intersect_fn is None:
        intersect_fn = make_brute_intersect(spheres, triangles)

    def stream_id(s, b, which):
        return (s * (max_depth * _N_STREAMS + 1) + b * _N_STREAMS + which) \
            & 0xFFFFFFFF

    def sample_body(s):
        ju, jv, lu1, lu2 = pcg.uniform4(pixel, s, stream_id(s, 0, 0), seed)
        u = true_divide(col_f + ju, du)
        v = true_divide(row_f + jv, dv)
        dx = llcx + u * hx + v * vx - ox0
        dy = llcy + u * hy + v * vy - oy0
        dz = llcz + u * hz + v * vz - oz0
        if len(cam) >= 19:
            # thin lens: polar disk sample from the raygen draw's two spare
            # outputs, offset along the camera's u/v basis
            (cux, cuy, cuz, cvx, cvy, cvz, lr) = cam[12:19]
            rad = lr * torch.sqrt(lu1)
            phi = pcg.TWO_PI_F32 * lu2
            cp = torch.cos(phi)
            sp_ = torch.sin(phi)
            offx = rad * (cp * cux + sp_ * cvx)
            offy = rad * (cp * cuy + sp_ * cvy)
            offz = rad * (cp * cuz + sp_ * cvz)
            dx, dy, dz = dx - offx, dy - offy, dz - offz
            dx, dy, dz = _norm3(dx, dy, dz)
            ox = ox0 + offx
            oy = oy0 + offy
            oz = oz0 + offz
        else:
            dx, dy, dz = _norm3(dx, dy, dz)
            ox = torch.zeros_like(dx) + ox0
            oy = torch.zeros_like(dx) + oy0
            oz = torch.zeros_like(dx) + oz0

        tr = torch.ones_like(dx)
        tg = torch.ones_like(dx)
        tb = torch.ones_like(dx)
        lr = torch.zeros_like(dx)
        lg = torch.zeros_like(dx)
        lb = torch.zeros_like(dx)
        alive = torch.ones_like(dx, dtype=torch.bool)

        for b in range(max_depth):
            # an intersect_fn that sets ``wants_bounce`` also gets the
            # bounce index (the counting walk's primary-bounce visits)
            if getattr(intersect_fn, "wants_bounce", False):
                hit, (px, py, pz), (nx, ny, nz), mats = intersect_fn(
                    (ox, oy, oz), (dx, dy, dz), alive, bounce=b
                )
            else:
                hit, (px, py, pz), (nx, ny, nz), mats = intersect_fn(
                    (ox, oy, oz), (dx, dy, dz), alive
                )
            (m_ar, m_ag, m_ab, m_er, m_eg, m_eb, m_metal, m_rough, m_ior,
             m_trans) = mats
            # ---- miss: sky gradient
            t_sky = 0.5 * (dy + 1.0)
            miss = alive & ~hit
            lr = lr + _select(miss, tr * (1.0 - t_sky + 0.5 * t_sky), 0.0)
            lg = lg + _select(miss, tg * (1.0 - t_sky + 0.7 * t_sky), 0.0)
            lb = lb + _select(miss, tb * (1.0 - t_sky + 1.0 * t_sky), 0.0)

            live = alive & hit
            # ---- emission accumulate
            lr = lr + _select(live, tr * m_er, 0.0)
            lg = lg + _select(live, tg * m_eg, 0.0)
            lb = lb + _select(live, tb * m_eb, 0.0)

            # Miss lanes would normalize a zero vector; give them a fixed
            # unit normal instead — their output is masked.
            nx = _select(hit, nx, 0.0)
            ny = _select(hit, ny, 1.0)
            nz = _select(hit, nz, 0.0)
            entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
            sgn = _select(entering, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            # ---- randomness for this bounce
            u_lobe, u_rr, u_d1, u_d2 = pcg.uniform4(
                pixel, s, stream_id(s, b, _S_LOBE), seed
            )
            f1, f2, f3, f4 = pcg.uniform4(
                pixel, s, stream_id(s, b, _S_FUZZ), seed
            )
            g1, g2 = pcg.box_muller(f1, f2)
            g3, _ = pcg.box_muller(f3, f4)
            u_trans, u_fres, _, _ = pcg.uniform4(
                pixel, s, stream_id(s, b, _S_GLASS), seed
            )

            # ---- specular lobe: mirror + roughness fuzz
            d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
            rx = dx - 2.0 * d_dot_n * nx
            ry = dy - 2.0 * d_dot_n * ny
            rz = dz - 2.0 * d_dot_n * nz
            ux, uy, uz = _norm3(g1, g2, g3)
            sx, sy, sz = _norm3(
                rx + m_rough * ux, ry + m_rough * uy, rz + m_rough * uz
            )

            # ---- dielectric sub-lobe (Schlick Fresnel + Snell)
            eta = _select(entering, 1.0 / m_ior, m_ior)
            cos_i = torch.clamp(-d_dot_n, 0.0, 1.0)
            sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            tir = sin2_t > 1.0
            # sqrt'(0) is infinite: guard the argument wherever cos_t is 0
            # (sin2_t >= 1, also at exactly 1, e.g. a grazing ray whose
            # cos_i^2 rounds away), so that a lane whose refraction is not
            # taken cannot turn its zero cotangent into inf * 0 = NaN.
            refracts = sin2_t < 1.0
            cos_t = torch.where(
                refracts,
                torch.sqrt(torch.where(refracts, 1.0 - sin2_t, 1.0)),
                0.0,
            )
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
            gx = _select(refl_choice, sx, fx)
            gy = _select(refl_choice, sy, fy)
            gz = _select(refl_choice, sz, fz)
            sx = _select(is_glass, gx, sx)
            sy = _select(is_glass, gy, sy)
            sz = _select(is_glass, gz, sz)

            # ---- diffuse lobe: cosine hemisphere via disk projection
            phi = pcg.TWO_PI_F32 * u_d1
            sq = torch.sqrt(u_d2)
            ddx = torch.cos(phi) * sq
            ddy = torch.sin(phi) * sq
            ddz = torch.sqrt(torch.clamp(1.0 - u_d2, min=0.0))
            # orthonormal basis about n (branchless helper-axis pick)
            pick_y = torch.abs(nx) > 0.1
            ax = _select(pick_y, 0.0, 1.0)
            ay = _select(pick_y, 1.0, 0.0)
            bux = ay * nz
            buy = -ax * nz
            buz = ax * ny - ay * nx
            bux, buy, buz = _norm3(bux, buy, buz)
            bvx = ny * buz - nz * buy
            bvy = nz * bux - nx * buz
            bvz = nx * buy - ny * bux
            cx_, cy_, cz_ = _norm3(
                ddx * bux + ddy * bvx + ddz * nx,
                ddx * buy + ddy * bvy + ddz * ny,
                ddx * buz + ddy * bvz + ddz * nz,
            )

            spec = u_lobe < m_metal
            ndx = _select(spec, sx, cx_)
            ndy = _select(spec, sy, cy_)
            ndz = _select(spec, sz, cz_)

            # ---- throughput *= albedo
            ntr = tr * m_ar
            ntg = tg * m_ag
            ntb = tb * m_ab

            survived = live
            if b > RR_START:
                # Russian roulette; a sampling decision, detached so the
                # fused path stays gradient-correct.
                p_cont = torch.clamp(
                    torch.maximum(ntr, torch.maximum(ntg, ntb)), 1e-6, RR_CAP
                ).detach()
                keep = ~(u_rr > p_cont)
                inv_p = 1.0 / p_cont
                ntr = _select(keep, ntr * inv_p, ntr)
                ntg = _select(keep, ntg * inv_p, ntg)
                ntb = _select(keep, ntb * inv_p, ntb)
                survived = survived & keep
                survived = survived & (
                    torch.maximum(ntr, torch.maximum(ntg, ntb)) >= CUTOFF
                )

            # offset along the hemisphere the new direction leaves through
            out_side = _dot3(ndx, ndy, ndz, nx, ny, nz) >= 0.0
            osgn = _select(out_side, 1.0, -1.0)
            nox = px + SCATTER_EPS * osgn * nx
            noy = py + SCATTER_EPS * osgn * ny
            noz = pz + SCATTER_EPS * osgn * nz

            ox = _select(survived, nox, ox)
            oy = _select(survived, noy, oy)
            oz = _select(survived, noz, oz)
            dx = _select(survived, ndx, dx)
            dy = _select(survived, ndy, dy)
            dz = _select(survived, ndz, dz)
            tr = _select(survived, ntr, tr)
            tg = _select(survived, ntg, tg)
            tb = _select(survived, ntb, tb)
            alive = survived

        return lr, lg, lb

    acc_r = acc_g = acc_b = torch.zeros_like(row_f)
    for s in range(sample_offset, sample_offset + spp):
        if remat:
            lr, lg, lb = checkpoint(sample_body, s, use_reentrant=False)
        else:
            lr, lg, lb = sample_body(s)
        acc_r, acc_g, acc_b = acc_r + lr, acc_g + lg, acc_b + lb
    return acc_r, acc_g, acc_b


# ----------------------------------------------------------------------------
# Host side: scene and camera tables
# ----------------------------------------------------------------------------

def pack_scene(scene):
    """(S, 16) sphere table: center, radius, pre-gathered material fields
    (differentiable in the material fields: the gather is the only
    indexing)."""
    sph, mats = scene.spheres, scene.materials
    m = sph.material.long()
    return torch.cat(
        [
            sph.centers,
            sph.radii[:, None],
            mats.albedo[m],
            mats.emission[m],
            mats.metallic[m][:, None],
            mats.roughness[m][:, None],
            mats.ior[m][:, None],
            mats.transmission[m][:, None],
            sph.centers.new_zeros((sph.count, 2)),
        ],
        dim=1,
    )


def pack_triangles(scene):
    """(T, 24) triangle table: v0, e1, e2, unit normal, material fields."""
    tris, mats = scene.triangles, scene.materials
    m = tris.material.long()
    return torch.cat(
        [
            tris.v0,
            tris.e1,
            tris.e2,
            tris.normal,
            mats.albedo[m],
            mats.emission[m],
            mats.metallic[m][:, None],
            mats.roughness[m][:, None],
            mats.ior[m][:, None],
            mats.transmission[m][:, None],
            tris.v0.new_zeros((tris.count, 2)),
        ],
        dim=1,
    )


def pack_camera(camera):
    """(1, 20) camera record: origin, llc, horizontal, vertical, lens u/v
    basis, lens_radius, pad."""
    return torch.cat(
        [
            camera.origin,
            camera.lower_left_corner,
            camera.horizontal,
            camera.vertical,
            camera.u,
            camera.v,
            camera.lens_radius.reshape(1),
            camera.origin.new_zeros(1),
        ]
    )[None, :]


def pack_tables(scene, camera):
    """The (1, 20) camera, (S, 16) sphere and (T, 24) triangle tables the
    tracers read, differentiable in every float field they carry."""
    return pack_camera(camera), pack_scene(scene), pack_triangles(scene)


def cam_tuple(cam_arr, has_lens: bool):
    """Scalar camera tuple for the tracers: 12 pinhole fields, or 19 with
    the thin-lens extension (u, v basis + lens_radius)."""
    return tuple(cam_arr[0, k] for k in range(19 if has_lens else 12))


def _check_fused_supported(scene):
    if scene.triangles.count > FUSED_TRI_LIMIT:
        raise ValueError(
            f"fused engines loop over every primitive and support at most "
            f"{FUSED_TRI_LIMIT} triangles (got {scene.triangles.count}); "
            f"large meshes use the BVH path"
        )


def _uv_scale(width, height, inclusive_uv):
    return (
        float(width - 1 if inclusive_uv else width),
        float(height - 1 if inclusive_uv else height),
    )


def _inv_spp(spp):
    return float(np.float32(1.0 / spp))


# ----------------------------------------------------------------------------
# The plain version: the whole image as tensor ops
# ----------------------------------------------------------------------------

def render_flat_fused(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    remat: bool = False,
    tables=None,
):
    """Plain-PyTorch render → flat (H*W, 3) bottom-up HDR buffer.

    Same math and RNG as the CUDA kernel, on the scene's device.
    ``remat`` checkpoints each sample (:func:`trace_tile`); ``tables``, the
    (camera, sphere, triangle) tables of :func:`pack_tables`, are traced in
    place of packing ``scene`` and ``camera`` (the differentiable step's
    backward differentiates through them).  Each call adds one to
    ``render_flat_fused.calls``."""
    render_flat_fused.calls += 1
    _check_fused_supported(scene)
    device = scene.device
    cam_arr, sph_arr, tri_arr = (
        tables if tables is not None else pack_tables(scene, camera))
    cam = cam_tuple(cam_arr, camera.has_lens)
    spheres = [
        tuple(sph_arr[k, f] for f in range(14))
        for k in range(sph_arr.shape[0])
    ]
    triangles = [
        tuple(tri_arr[k, f] for f in range(22))
        for k in range(tri_arr.shape[0])
    ]
    pixel = torch.arange(height * width, dtype=torch.int64, device=device)
    du, dv = _uv_scale(width, height, inclusive_uv)
    r, g, b = trace_tile(
        pixel,
        (pixel // width).to(torch.float32),
        (pixel % width).to(torch.float32),
        cam,
        spheres,
        triangles,
        seed=seed,
        spp=spp,
        max_depth=max_depth,
        du=du,
        dv=dv,
        remat=remat,
    )
    inv = _inv_spp(spp)
    return torch.stack([r * inv, g * inv, b * inv], dim=-1)


#: Plain-tracer calls since the count was last reset (set it to 0 to reset).
render_flat_fused.calls = 0


# ----------------------------------------------------------------------------
# The CUDA kernel
# ----------------------------------------------------------------------------

_ARGTYPES = (
    ctypes.c_void_p,  # cam
    ctypes.c_void_p,  # spheres
    ctypes.c_int,  # n_spheres
    ctypes.c_void_p,  # tris
    ctypes.c_int,  # n_tris
    ctypes.c_void_p,  # out
    ctypes.c_int,  # width
    ctypes.c_int,  # height
    ctypes.c_int,  # spp
    ctypes.c_int,  # max_depth
    ctypes.c_uint32,  # seed
    ctypes.c_float,  # du
    ctypes.c_float,  # dv
    ctypes.c_float,  # inv_spp
    ctypes.c_int,  # has_lens
    ctypes.c_void_p,  # stream
)


def _check_table(name, t, device, cols):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the scene on {device}")
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(
            f"{name} must be float32 (n, {cols}), got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch_args(device, width, height, spp, max_depth, what):
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    if min(width, height, spp) < 1 or max_depth < 0:
        raise ValueError(
            f"need width, height, spp >= 1 and max_depth >= 0, got "
            f"{width}x{height}, spp {spp}, max_depth {max_depth}"
        )


def _check_smem(*tables):
    """The tables a kernel stages in shared memory fit its budget."""
    smem = 4 * sum(t.numel() for t in tables)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"scene tables take {smem} bytes, over the kernel's "
            f"{_SMEM_LIMIT}-byte shared-memory budget"
        )


def _launch_error(what, err):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def render_flat_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    tables=None,
):
    """CUDA-kernel render → flat (H*W, 3) bottom-up HDR buffer.

    A scene on a CUDA device launches ``csrc/megakernel.cu`` (built on
    first use) and adds one to ``render_flat_megakernel.launches``.  A scene
    on the CPU runs the plain version, :func:`render_flat_fused`.  Any other
    device, and any input the kernel does not take, raises.  ``tables``
    (:func:`pack_tables`) are rendered in place of packing ``scene`` and
    ``camera``.
    """
    _check_fused_supported(scene)
    device = scene.device
    if device.type == "cpu":
        return render_flat_fused(
            scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
            tables=tables,
        )
    _check_launch_args(device, width, height, spp, max_depth,
                       "render_flat_megakernel")
    with torch.no_grad():
        cam, sph, tri = (t.contiguous() for t in (
            tables if tables is not None else pack_tables(scene, camera)))
    _check_table("camera table", cam, device, N_CAM_FIELDS)
    _check_table("sphere table", sph, device, N_SPHERE_FIELDS)
    _check_table("triangle table", tri, device, N_TRI_FIELDS)
    _check_smem(cam, sph, tri)
    du, dv = _uv_scale(width, height, inclusive_uv)
    out = torch.empty((height * width, 3), dtype=torch.float32, device=device)
    fn = _build.entry("megakernel", "spira_megakernel_render", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            cam.data_ptr(), sph.data_ptr(), sph.shape[0], tri.data_ptr(),
            tri.shape[0], out.data_ptr(), width, height, spp, max_depth,
            seed & 0xFFFFFFFF, du, dv, _inv_spp(spp), int(camera.has_lens),
            stream,
        )
    _launch_error("megakernel", err)
    render_flat_megakernel.launches += 1
    return out


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_flat_megakernel.launches = 0


# ----------------------------------------------------------------------------
# The differentiable step: kernel forward, adjoint-kernel backward
# ----------------------------------------------------------------------------

class _HybridGrad(torch.autograd.Function):
    """Image of the packed tables; the backward is a vector-Jacobian
    product at ``grad_spp`` samples (:func:`.grad_megakernel.
    render_grad_megakernel` in VJP mode: the adjoint kernel on the card,
    autograd through the plain tracer on the CPU)."""

    @staticmethod
    def forward(ctx, cam, sph, tri, scene, camera, kw):
        ctx.save_for_backward(cam, sph, tri)
        ctx.scene, ctx.camera, ctx.kw = scene, camera, kw
        return render_flat_megakernel(
            scene, camera, tables=(cam, sph, tri), width=kw["width"],
            height=kw["height"], spp=kw["spp"], max_depth=kw["max_depth"],
            seed=kw["seed"], inclusive_uv=kw["inclusive_uv"],
        )

    @staticmethod
    def backward(ctx, g):
        from .grad_megakernel import render_grad_megakernel

        _, dcam, dsph, dtri = render_grad_megakernel(
            ctx.scene, ctx.camera, ctx.saved_tensors,
            g.to(torch.float32).contiguous(), loss_mode=False, **ctx.kw)
        return dcam, dsph, dtri, None, None, None


def render_flat_hybrid_grad(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    grad_spp: int | None = None,
    inclusive_uv: bool = True,
):
    """Differentiable flat render → (H*W, 3) bottom-up HDR buffer.

    Forward: :func:`render_flat_megakernel` at ``spp`` (the CUDA kernel on
    the card, the plain tracer on the CPU).  Backward: path replay of the
    first ``grad_spp`` samples (default ``spp``) through the adjoint of the
    same tracer, the unbiased stochastic-gradient estimator when
    ``grad_spp < spp`` and the exact gradient of the rendered estimator
    when they are equal.  Gradients reach every float field of the scene
    and camera that the packed tables carry (materials, sphere centres and
    radii, triangle ``v0``/``e1``/``e2``/``normal``, the camera frame and
    lens) through the packing's gather; the seed gets none.
    """
    _check_fused_supported(scene)
    kw = dict(width=width, height=height, spp=spp,
              grad_spp=spp if grad_spp is None else grad_spp,
              max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv)
    return _HybridGrad.apply(*pack_tables(scene, camera), scene, camera, kw)
