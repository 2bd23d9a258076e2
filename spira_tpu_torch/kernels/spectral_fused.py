"""Hero-wavelength spectral tracer (small scenes, physical semantics): the
host side, the plain PyTorch tracer, and the wrapper of the CUDA kernel.

Counterpart of :mod:`spira_tpu.kernels.spectral_fused`, the spectral twin
of :mod:`spira_tpu_torch.kernels.megakernel`:

* Material SPDs are **Chebyshev-compressed**: ``colorimetry.N_CHEB``
  coefficients per spectrum, fitted from the 24-bin tables at pack time as
  one float32 ``einsum`` against the least-squares pseudo-inverse
  ``_CHEB_PINV``.  An SPD at a wavelength is a Clenshaw recurrence.
* The sky gradient always satisfies r ≤ g ≤ b, so its Smits upsample is a
  single-ordering blend of three Chebyshev-fitted basis spectra.
* Each path carries four wavelengths (a hero and three stratified
  rotations); scatter geometry is decided at the hero wavelength, and a
  dispersive refraction collapses the path to the hero lane (×4).
* The film converts spectral radiance to CIE XYZ with the analytic CMF fits
  per sample; linear sRGB comes out of one 3×3 product at the end.

Every record — the (M, 29) material table, a sphere (S, 33) and a
triangle (T, 41) — carries the same 29-float material record
``metal rough ior trans cauchy alb[12] emi[12]``, at offset 0, 4 and 12.

The tracer runs two ways:

* :func:`render_flat_spectral_megakernel` — the hand-written CUDA kernel
  (``csrc/spectral_megakernel.cu``, ``spira_spectral_render``) for scenes
  on a CUDA device; for scenes on the CPU, the plain version.
* :func:`render_flat_fused_spectral` — :func:`trace_tile_spectral`, the same
  math as whole-image tensor ops, on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core import colorimetry as cl
from ..core import pcg
from ..core.device import device_constant
from . import megakernel as mk

W = cl.N_WAVELENGTHS
D = cl.N_CHEB

# PCG stream ids: the per-bounce ids are the RGB tracer's; these two are
# one-off draws per sample.
_S_WAVELENGTH = 10_000  # hero wavelength + raygen jitter
_S_LENS = 10_001  # thin-lens disk sample

#: material record: metal, rough, ior, trans, cauchy_b, alb_cheb[D],
#: emi_cheb[D]
N_MAT_SPEC = 5 + 2 * D
N_SPH_SPEC = 9 + 2 * D  # center, radius, material record
N_TRI_SPEC = 17 + 2 * D  # v0, e1, e2, unit normal, material record
_ALB = 5  # offset of alb_cheb in the material record
_EMI = 5 + D  # offset of emi_cheb

_LAMBDA_MIN = float(np.float32(cl.LAMBDA_MIN))
_LAMBDA_RANGE = float(np.float32(cl.LAMBDA_RANGE))


def _cheb(coeffs, x):
    """Clenshaw evaluation of Chebyshev coefficients at unit-interval x:
    ``b1 = 2*x*b1 - b2 + c`` from the highest coefficient down, then
    ``x*b1 - b2 + c0``."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * x * b1 - b2 + c, b1
    return x * b1 - b2 + coeffs[0]


def _f32_tuple(values):
    return tuple(float(v) for v in np.asarray(values, np.float32))


_SKY_WHITE = _f32_tuple(cl.SMITS_CHEB["white"])
_SKY_CYAN = _f32_tuple(cl.SMITS_CHEB["cyan"])
_SKY_BLUE = _f32_tuple(cl.SMITS_CHEB["blue"])

#: The Chebyshev least-squares fit is a fixed linear map of the SPD table:
#: its pseudo-inverse, computed once on the host, applied as one einsum.
_CHEB_PINV = np.linalg.pinv(
    np.polynomial.chebyshev.chebvander(
        2.0 * (cl.SPD_GRID - cl.LAMBDA_MIN) / cl.LAMBDA_RANGE - 1.0, D - 1
    ).astype(np.float64)
).astype(np.float32)  # (D, K)


# ----------------------------------------------------------------------------
# Host side: spectral tables
# ----------------------------------------------------------------------------

def pack_materials_spectral(materials):
    """(M, 29) spectral material table: metal, rough, ior, trans, cauchy_b,
    then the Chebyshev fits of ``albedo_spd`` and ``emission_spd``
    (differentiable in every field)."""
    cauchy = (materials.cauchy_b if materials.cauchy_b is not None
              else materials.ior * 0.0)
    return torch.cat(
        [
            materials.metallic[:, None],
            materials.roughness[:, None],
            materials.ior[:, None],
            materials.transmission[:, None],
            cauchy[:, None],
            *cheb_fits(materials),
        ],
        dim=1,
    )


def cheb_fits(materials):
    """The (M, D) Chebyshev fits of ``albedo_spd`` and ``emission_spd``:
    one einsum each against ``_CHEB_PINV`` (a device constant), the
    columns of the material record that are arithmetic, not gathers."""
    if materials.albedo_spd is None or materials.emission_spd is None:
        raise ValueError(
            "materials carry no albedo_spd/emission_spd tables; build them "
            "with make_materials (Smits upsampling)"
        )
    pinv = device_constant("CHEB_PINV", _CHEB_PINV, materials.albedo.device)
    return (torch.einsum("dk,mk->md", pinv, materials.albedo_spd),
            torch.einsum("dk,mk->md", pinv, materials.emission_spd))


def _sphere_records(scene, mat):
    sph = scene.spheres
    return torch.cat([sph.centers, sph.radii[:, None],
                      mat[sph.material.long()]], dim=1)


def pack_scene_spectral(scene):
    """Spectral scene tables: spheres (S, 33) and triangles (T, 41), each
    record its geometry followed by its material's 29-float record."""
    mat = pack_materials_spectral(scene.materials)
    tri = scene.triangles
    return _sphere_records(scene, mat), torch.cat(
        [tri.v0, tri.e1, tri.e2, tri.normal, mat[tri.material.long()]],
        dim=1)


_SKY_TABLE = np.asarray([_SKY_WHITE, _SKY_CYAN, _SKY_BLUE], np.float32)


def sky_table(device):
    """(3, D) Chebyshev coefficients of the sky's white, cyan and blue
    basis spectra, for the CUDA kernels (a device constant)."""
    return device_constant("SKY_TABLE", _SKY_TABLE, device)


# ----------------------------------------------------------------------------
# The plain version: the whole image as tensor ops
# ----------------------------------------------------------------------------

def _miss_record(like):
    """The material of a lane that hits nothing: ior 1, everything else 0."""
    rec = torch.zeros((1, N_MAT_SPEC), dtype=like.dtype, device=like.device)
    rec[0, 2] = 1.0
    return rec


def make_brute_intersect_spectral(spheres, triangles=None):
    """Nearest hit over every record of the spectral tables ``spheres``
    (S, 33) and ``triangles`` (T, 41; ``None``: none), in a static loop.

    Returns ``intersect(o3, d3, active) -> (hit, t_safe, n3, mat)`` where
    ``t_safe`` is the hit distance (1.0 on a miss), ``n3`` the unit
    geometric normal before face-forwarding ((0, 1, 0) on a miss) and
    ``mat`` the (N, 29) material record of each lane's hit.  ``active`` is
    not needed here.  The spectral packed-BVH path substitutes its walk
    (``spectral_bvh.make_packed_intersect_spectral``)."""
    if triangles is None:
        triangles = spheres.new_zeros((0, N_TRI_SPEC))
    n_sph = spheres.shape[0]
    records = torch.cat([spheres[:, 4:], triangles[:, 12:],
                         _miss_record(spheres)])
    sph = [tuple(spheres[k, f] for f in range(4)) for k in range(n_sph)]
    tris = [tuple(triangles[k, f] for f in range(12))
            for k in range(triangles.shape[0])]

    def intersect(o3, d3, active=None):
        ox, oy, oz = o3
        dx, dy, dz = d3
        best_t = torch.full_like(dx, mk.INF)
        best = torch.full(dx.shape, records.shape[0] - 1, dtype=torch.long,
                          device=dx.device)
        ncx = torch.zeros_like(dx)
        ncy = torch.zeros_like(dx)
        ncz = torch.zeros_like(dx)
        inv_r = torch.zeros_like(dx)
        tnx = torch.zeros_like(dx)
        tny = torch.zeros_like(dx)
        tnz = torch.zeros_like(dx)
        is_tri = torch.zeros_like(dx, dtype=torch.bool)
        for k, (cx, cy, cz, r) in enumerate(sph):
            ocx = ox - cx
            ocy = oy - cy
            ocz = oz - cz
            half_b = mk._dot3(ocx, ocy, ocz, dx, dy, dz)
            c = mk._dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - c
            disc_ok = disc > 0.0
            sqrtd = torch.where(
                disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0)
            root0 = -half_b - sqrtd
            root1 = -half_b + sqrtd
            root = torch.where(root0 > mk.T_MIN, root0, root1)
            hit_k = disc_ok & (root > mk.T_MIN) & (root < best_t)
            best_t = torch.where(hit_k, root, best_t)
            best = torch.where(hit_k, k, best)
            ncx = torch.where(hit_k, cx, ncx)
            ncy = torch.where(hit_k, cy, ncy)
            ncz = torch.where(hit_k, cz, ncz)
            inv_r = torch.where(hit_k, 1.0 / r, inv_r)
            is_tri = is_tri & ~hit_k
        for k, (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nxc, nyc,
                nzc) in enumerate(tris):
            # Möller–Trumbore
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = torch.abs(det) > 1e-12
            inv_det = torch.where(
                det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
            tvx = ox - v0x
            tvy = oy - v0y
            tvz = oz - v0z
            uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            hit_k = ((torch.abs(det) > 1e-9) & (uu >= 0.0) & (vv >= 0.0)
                     & (uu + vv <= 1.0) & (tt > mk.T_MIN) & (tt < best_t))
            best_t = torch.where(hit_k, tt, best_t)
            best = torch.where(hit_k, n_sph + k, best)
            tnx = torch.where(hit_k, nxc, tnx)
            tny = torch.where(hit_k, nyc, tny)
            tnz = torch.where(hit_k, nzc, tnz)
            is_tri = is_tri | hit_k

        hit = best_t < mk.INF
        t_safe = torch.where(hit, best_t, 1.0)
        nx, ny, nz = mk._norm3((ox + t_safe * dx - ncx) * inv_r,
                               (oy + t_safe * dy - ncy) * inv_r,
                               (oz + t_safe * dz - ncz) * inv_r)
        nx = torch.where(hit, torch.where(is_tri, tnx, nx), 0.0)
        ny = torch.where(hit, torch.where(is_tri, tny, ny), 1.0)
        nz = torch.where(hit, torch.where(is_tri, tnz, nz), 0.0)
        return hit, t_safe, (nx, ny, nz), records[best]

    return intersect


def trace_tile_spectral(
    pixel,
    row_f,
    col_f,
    cam,
    spheres,
    triangles=None,
    *,
    seed,
    spp: int,
    max_depth: int,
    du: float,
    dv: float,
    intersect_fn=None,
):
    """Spectral transport for a batch of pixels; returns the summed XYZ
    (x, y, z) over ``spp`` samples.

    pixel: int64 PCG counters (row * width + col); row_f/col_f: float pixel
    coordinates (row counted from the image bottom); cam: the camera tuple
    (:func:`megakernel.cam_tuple`); spheres, triangles: the (S, 33) and
    (T, 41) tables of :func:`pack_scene_spectral`.  ``intersect_fn`` (see
    :func:`make_brute_intersect_spectral` for the contract) overrides the
    nearest-hit query.  Forward only.
    """
    (ox0, oy0, oz0, llcx, llcy, llcz, hx, hy, hz, vx, vy, vz) = cam[:12]
    if intersect_fn is None:
        intersect_fn = make_brute_intersect_spectral(spheres, triangles)
    scale = film_scale()

    def stream_id(s, b, which):
        return (s * (max_depth * mk._N_STREAMS + 1) + b * mk._N_STREAMS
                + which) & 0xFFFFFFFF

    def sample_body(s):
        # ---- wavelength lanes: hero + stratified rotations
        u_l, ju, jv, _ = pcg.uniform4(pixel, s, _S_WAVELENGTH, seed)
        lam = [_LAMBDA_MIN + torch.remainder(u_l + j / W, 1.0) * _LAMBDA_RANGE
               for j in range(W)]
        # unit-interval coordinate per lane, for the Chebyshev fits
        lam_x = [mk.true_divide(2.0 * (x - _LAMBDA_MIN), _LAMBDA_RANGE) - 1.0
                 for x in lam]
        sky = [(_cheb(_SKY_WHITE, x), _cheb(_SKY_CYAN, x),
                _cheb(_SKY_BLUE, x)) for x in lam_x]

        # ---- primary ray (pinhole, or thin lens from its own stream)
        u = mk.true_divide(col_f + ju, du)
        v = mk.true_divide(row_f + jv, dv)
        dx = llcx + u * hx + v * vx - ox0
        dy = llcy + u * hy + v * vy - oy0
        dz = llcz + u * hz + v * vz - oz0
        if len(cam) >= 19:
            lu1, lu2, _, _ = pcg.uniform4(pixel, s, _S_LENS, seed)
            (cux, cuy, cuz, cvx, cvy, cvz, lr) = cam[12:19]
            rad = lr * torch.sqrt(lu1)
            phi = pcg.TWO_PI_F32 * lu2
            cp = torch.cos(phi)
            sp_ = torch.sin(phi)
            offx = rad * (cp * cux + sp_ * cvx)
            offy = rad * (cp * cuy + sp_ * cvy)
            offz = rad * (cp * cuz + sp_ * cvz)
            dx, dy, dz = mk._norm3(dx - offx, dy - offy, dz - offz)
            ox = ox0 + offx
            oy = oy0 + offy
            oz = oz0 + offz
        else:
            dx, dy, dz = mk._norm3(dx, dy, dz)
            ox = torch.zeros_like(dx) + ox0
            oy = torch.zeros_like(dx) + oy0
            oz = torch.zeros_like(dx) + oz0

        thr = [torch.ones_like(dx) for _ in range(W)]
        rad = [torch.zeros_like(dx) for _ in range(W)]
        alive = torch.ones_like(dx, dtype=torch.bool)
        collapsed = torch.zeros_like(dx, dtype=torch.bool)

        for b in range(max_depth):
            hit, best_t, (nx, ny, nz), mat = intersect_fn(
                (ox, oy, oz), (dx, dy, dz), alive)
            m_metal, m_rough, m_ior, m_trans, m_cauchy = mat[:, :5].unbind(1)
            m_alb = [mat[:, _ALB + i] for i in range(D)]
            m_emi = [mat[:, _EMI + i] for i in range(D)]

            # ---- sky: single-ordering Smits blend (r <= g <= b always)
            t_sky = 0.5 * (dy + 1.0)
            sky_r = 1.0 - t_sky + 0.5 * t_sky
            sky_g = 1.0 - t_sky + 0.7 * t_sky
            sky_b = 1.0 - t_sky + 1.0 * t_sky
            miss = alive & ~hit
            for j, (white, cyan, blue) in enumerate(sky):
                sky_spd = torch.clamp(
                    sky_r * white + (sky_g - sky_r) * cyan
                    + (sky_b - sky_g) * blue, min=0.0)
                rad[j] = rad[j] + torch.where(miss, thr[j] * sky_spd, 0.0)

            # ---- emission and albedo at each lane's wavelength
            live = alive & hit
            alb_lam = []
            for j in range(W):
                emi_j = torch.clamp(_cheb(m_emi, lam_x[j]), min=0.0)
                rad[j] = rad[j] + torch.where(live, thr[j] * emi_j, 0.0)
                alb_lam.append(torch.clamp(_cheb(m_alb, lam_x[j]), min=0.0))

            # ---- geometry
            px = ox + best_t * dx
            py = oy + best_t * dy
            pz = oz + best_t * dz
            entering = mk._dot3(dx, dy, dz, nx, ny, nz) < 0.0
            sgn = torch.where(entering, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            # ---- randomness for this bounce
            u_lobe, u_rr, u_d1, u_d2 = pcg.uniform4(
                pixel, s, stream_id(s, b, mk._S_LOBE), seed)
            f1, f2, f3, f4 = pcg.uniform4(
                pixel, s, stream_id(s, b, mk._S_FUZZ), seed)
            g1, g2 = pcg.box_muller(f1, f2)
            g3, _ = pcg.box_muller(f3, f4)
            u_trans, u_fres, _, _ = pcg.uniform4(
                pixel, s, stream_id(s, b, mk._S_GLASS), seed)

            # ---- specular: mirror + fuzz
            d_dot_n = mk._dot3(dx, dy, dz, nx, ny, nz)
            rx = dx - 2.0 * d_dot_n * nx
            ry = dy - 2.0 * d_dot_n * ny
            rz = dz - 2.0 * d_dot_n * nz
            ux, uy, uz = mk._norm3(g1, g2, g3)
            sx, sy, sz = mk._norm3(rx + m_rough * ux, ry + m_rough * uy,
                                   rz + m_rough * uz)

            # ---- dielectric at the hero wavelength: n(λ) = ior + B/λ²(µm)
            lam_um = lam[0] * float(np.float32(1e-3))
            ior_h = m_ior + m_cauchy / (lam_um * lam_um)
            eta = torch.where(entering, 1.0 / ior_h, ior_h)
            cos_i = torch.clamp(-d_dot_n, 0.0, 1.0)
            sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            tir = sin2_t > 1.0
            cos_t = torch.where(
                tir, 0.0, torch.sqrt(torch.where(tir, 1.0, 1.0 - sin2_t)))
            fx = eta * dx + (eta * cos_i - cos_t) * nx
            fy = eta * dy + (eta * cos_i - cos_t) * ny
            fz = eta * dz + (eta * cos_i - cos_t) * nz
            fx, fy, fz = mk._norm3(fx, fy, fz)
            q = (1.0 - ior_h) / (1.0 + ior_h)
            r0 = q * q
            one_m = 1.0 - cos_i
            schlick = r0 + (1.0 - r0) * one_m * one_m * one_m * one_m * one_m
            refl_choice = tir | (u_fres < schlick)
            is_glass = u_trans < m_trans
            sx = torch.where(is_glass, torch.where(refl_choice, sx, fx), sx)
            sy = torch.where(is_glass, torch.where(refl_choice, sy, fy), sy)
            sz = torch.where(is_glass, torch.where(refl_choice, sz, fz), sz)
            dispersive = is_glass & ~refl_choice & (m_cauchy > 0.0)

            # ---- diffuse: cosine hemisphere via disk projection
            phi = pcg.TWO_PI_F32 * u_d1
            sq = torch.sqrt(u_d2)
            ddx = torch.cos(phi) * sq
            ddy = torch.sin(phi) * sq
            ddz = torch.sqrt(torch.clamp(1.0 - u_d2, min=0.0))
            pick_y = torch.abs(nx) > 0.1
            ax = torch.where(pick_y, 0.0, 1.0)
            ay = torch.where(pick_y, 1.0, 0.0)
            bux, buy, buz = mk._norm3(ay * nz, -ax * nz, ax * ny - ay * nx)
            bvx = ny * buz - nz * buy
            bvy = nz * bux - nx * buz
            bvz = nx * buy - ny * bux
            cx_, cy_, cz_ = mk._norm3(
                ddx * bux + ddy * bvx + ddz * nx,
                ddx * buy + ddy * bvy + ddz * ny,
                ddx * buz + ddy * bvz + ddz * nz,
            )

            spec = u_lobe < m_metal
            ndx = torch.where(spec, sx, cx_)
            ndy = torch.where(spec, sy, cy_)
            ndz = torch.where(spec, sz, cz_)

            # ---- spectral throughput update + hero collapse
            do_collapse = spec & dispersive & ~collapsed
            new_thr = [thr[j] * alb_lam[j] for j in range(W)]
            new_thr[0] = torch.where(do_collapse, new_thr[0] * float(W),
                                     new_thr[0])
            for j in range(1, W):
                new_thr[j] = torch.where(do_collapse, 0.0, new_thr[j])
            collapsed = collapsed | do_collapse

            survived = live
            if b > mk.RR_START:
                # Russian roulette on the largest lane
                tmax = new_thr[0]
                for t in new_thr[1:]:
                    tmax = torch.maximum(tmax, t)
                p_cont = torch.clamp(tmax, 1e-6, mk.RR_CAP)
                keep = ~(u_rr > p_cont)
                inv_p = 1.0 / p_cont
                new_thr = [torch.where(keep, t * inv_p, t) for t in new_thr]
                survived = survived & keep
                tmax = new_thr[0]
                for t in new_thr[1:]:
                    tmax = torch.maximum(tmax, t)
                survived = survived & (tmax >= mk.CUTOFF)

            # offset along the hemisphere the new direction leaves through
            out_side = mk._dot3(ndx, ndy, ndz, nx, ny, nz) >= 0.0
            osgn = torch.where(out_side, 1.0, -1.0)
            ox = torch.where(survived, px + mk.SCATTER_EPS * osgn * nx, ox)
            oy = torch.where(survived, py + mk.SCATTER_EPS * osgn * ny, oy)
            oz = torch.where(survived, pz + mk.SCATTER_EPS * osgn * nz, oz)
            dx = torch.where(survived, ndx, dx)
            dy = torch.where(survived, ndy, dy)
            dz = torch.where(survived, ndz, dz)
            thr = [torch.where(survived, nt, t)
                   for nt, t in zip(new_thr, thr)]
            alive = survived

        # ---- film: spectral radiance → XYZ (MC over λ, pdf = 1/range)
        sx_ = torch.zeros_like(row_f)
        sy_ = torch.zeros_like(row_f)
        sz_ = torch.zeros_like(row_f)
        for j in range(W):
            cmx, cmy, cmz = cl.cmf_xyz_components(lam[j])
            sx_ = sx_ + rad[j] * cmx
            sy_ = sy_ + rad[j] * cmy
            sz_ = sz_ + rad[j] * cmz
        return sx_ * scale, sy_ * scale, sz_ * scale

    acc_x = acc_y = acc_z = torch.zeros_like(row_f)
    for s in range(spp):
        x, y, z = sample_body(s)
        acc_x, acc_y, acc_z = acc_x + x, acc_y + y, acc_z + z
    return acc_x, acc_y, acc_z


def film_scale():
    """float32(LAMBDA_RANGE / Y_INTEGRAL / W): the film's weight of one
    wavelength lane's radiance times its CMF value."""
    return float(np.float32(cl.LAMBDA_RANGE / cl.Y_INTEGRAL / W))


def render_traced(scene, camera, *, width, height, spp, max_depth, seed,
                  inclusive_uv, spheres, triangles=None, intersect_fn=None):
    """Run :func:`trace_tile_spectral` over the whole image and convert:
    flat (H*W, 3) bottom-up linear sRGB."""
    cam = mk.cam_tuple(mk.pack_camera(camera), camera.has_lens)
    pixel = torch.arange(height * width, dtype=torch.int64,
                         device=scene.device)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    x, y, z = trace_tile_spectral(
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
        intersect_fn=intersect_fn,
    )
    inv = mk._inv_spp(spp)
    return cl.xyz_to_rgb(torch.stack([x * inv, y * inv, z * inv], dim=-1))


def _check_spectral_supported(scene):
    if scene.triangles.count > mk.FUSED_TRI_LIMIT:
        raise ValueError(
            f"the fused spectral engines loop over every primitive and "
            f"support at most {mk.FUSED_TRI_LIMIT} triangles (got "
            f"{scene.triangles.count}); large meshes use the spectral BVH "
            f"path"
        )


def render_flat_fused_spectral(
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
    """Plain-PyTorch spectral render → flat (H*W, 3) bottom-up linear-sRGB
    buffer.  Same math and RNG as the CUDA kernel, on the scene's device."""
    _check_spectral_supported(scene)
    sph, tri = pack_scene_spectral(scene)
    return render_traced(
        scene, camera, width=width, height=height, spp=spp,
        max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
        spheres=sph, triangles=tri,
    )


# ----------------------------------------------------------------------------
# The CUDA kernel
# ----------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _SpectralMaterialFields(ctypes.Structure):
    _fields_ = [(name, _VP) for name in (
        "metallic", "roughness", "ior", "transmission", "cauchy",
        "alb_cheb", "emi_cheb")] + [("cheb_rs", ctypes.c_int64),
                                    ("cheb_cs", ctypes.c_int64),
                                    ("n_mats", _I)]


class _SpectralTables(ctypes.Structure):
    """``csrc/scene_tables.cuh:SpectralTables``: the scene's arrays, the
    sky constant and the Chebyshev fits."""

    _fields_ = [("camera", mk.CameraFields), ("sky", _VP),
                ("geo", mk.GeometryFields),
                ("mats", _SpectralMaterialFields)]


_ARGTYPES = (
    ctypes.POINTER(_SpectralTables),  # tables
    _VP, _I, _I, _I, _I,  # out, width, height, spp, max_depth
    ctypes.c_uint32, _F, _F, _F, _F, _I,  # seed, du, dv, inv_spp,
                                          # film_scale, has_lens
    _VP,  # stream
)


def _spectral_tables(scene, camera, fits, device, keep):
    """The kernel's ``SpectralTables`` over the scene's arrays (held in
    ``keep``) and the Chebyshev fits ``fits`` (:func:`cheb_fits`, which the
    caller holds)."""
    m = scene.materials
    n = m.count
    alb, emi = fits
    if alb.stride() != emi.stride():
        raise ValueError("the albedo and emission fits differ in layout")
    ptr = {name: mk._field(f"material {name}", getattr(m, name), device,
                           (n,), keep)
           for name in ("metallic", "roughness", "ior", "transmission")}
    cauchy = (None if m.cauchy_b is None else
              mk._field("material cauchy_b", m.cauchy_b, device, (n,), keep))
    for name, t in (("albedo", alb), ("emission", emi)):
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != (n, D):
            raise ValueError(f"the {name} fit must be float32 ({n}, {D}) on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    mats = _SpectralMaterialFields(
        **ptr, cauchy=cauchy, alb_cheb=alb.data_ptr(),
        emi_cheb=emi.data_ptr(), cheb_rs=alb.stride(0),
        cheb_cs=alb.stride(1), n_mats=n)
    return _SpectralTables(camera=mk.camera_fields(camera, device, keep),
                           sky=sky_table(device).data_ptr(),
                           geo=mk.geometry_fields(scene, device, keep),
                           mats=mats)


def render_flat_spectral_megakernel(
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
    """Spectral CUDA-kernel render → flat (H*W, 3) bottom-up linear-sRGB
    buffer.

    A scene on a CUDA device launches ``spira_spectral_render`` of
    ``csrc/spectral_megakernel.cu`` (built on first use), which gathers the
    records :func:`pack_scene_spectral` builds from the scene's arrays and
    the Chebyshev fits (:func:`cheb_fits`, two torch ops ahead of it) and
    writes XYZ, and adds one to
    ``render_flat_spectral_megakernel.launches``; the 3×3 conversion to
    sRGB follows as a torch op, and the frame waits for nothing.  A scene
    on the CPU runs the plain version, :func:`render_flat_fused_spectral`.
    Any other device, and any input the kernel does not take, raises.
    """
    _check_spectral_supported(scene)
    device = scene.device
    if device.type == "cpu":
        return render_flat_fused_spectral(
            scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
        )
    mk._check_launch_args(device, width, height, spp, max_depth,
                          "render_flat_spectral_megakernel")
    keep = []  # every tensor read by pointer, held until the launch
    with torch.no_grad():
        fits = cheb_fits(scene.materials)
    src = _spectral_tables(scene, camera, fits, device, keep)
    mk._check_smem(floats=mk.N_CAM_FIELDS + 3 * D
                   + src.geo.n_spheres * N_SPH_SPEC
                   + src.geo.n_tris * N_TRI_SPEC)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    out = torch.empty((height * width, 3), dtype=torch.float32, device=device)
    fn = mk._entry("spectral_megakernel", "spira_spectral_render", _ARGTYPES,
                   _SpectralTables, "spira_spectral_tables_bytes")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            ctypes.byref(src), out.data_ptr(), width, height, spp, max_depth,
            seed & 0xFFFFFFFF, du, dv, mk._inv_spp(spp), film_scale(),
            int(camera.has_lens), stream,
        )
    mk._launch_error("spectral_megakernel", err)
    render_flat_spectral_megakernel.launches += 1
    # XYZ -> linear sRGB outside the kernel, as the JAX package does
    return cl.xyz_to_rgb(out)


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_flat_spectral_megakernel.launches = 0
