"""Hero-wavelength spectral path tracing on the wavefront.

Counterpart of :mod:`spira_tpu.integrator.spectral`.  Each path carries
``N_WAVELENGTHS`` wavelengths, a hero drawn uniformly over the visible
range and its stratified rotations; the hero decides the scatter geometry,
and the throughput is per wavelength through the material SPD tables.
The first dispersive refraction (``cauchy_b > 0``) collapses the path to
its hero wavelength (the other lanes zeroed, the hero times W).  At the
film each sample goes to XYZ through the CIE fits and on to linear sRGB.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import colorimetry as cl
from ..core import rng as srng
from ..core import vecmath as vm
from ..core.device import device_constant
from ..core.vecmath import SCATTER_EPS
from ..kernels import row_gather
from . import bsdf
from .intersect import intersect_scene
from .path_trace import russian_roulette_step

W = cl.N_WAVELENGTHS
#: a collapsed path's spectral weights: the hero lane times W, the rest 0
_HERO_ONLY = np.asarray([W] + [0] * (W - 1), np.float32)


def sample_wavelengths(key, n_rays, device=None):
    """Hero + stratified-rotation wavelengths, (N, W); pdf 1/range each."""
    u = srng.uniform(srng.bounce_key(key, 0, srng.Stream.WAVELENGTH),
                     (n_rays, 1), device)
    offsets = torch.arange(W, dtype=torch.float32, device=u.device) / W
    frac = torch.fmod(u + offsets[None, :], 1.0)
    return cl.LAMBDA_MIN + frac * cl.LAMBDA_RANGE


def trace_spectral(scene, origins, directions, sample_key, *,
                   max_depth: int, russian_roulette: bool = True,
                   intersect_fn=None):
    """Estimate linear sRGB radiance (N, 3) for a wavefront through
    spectral transport.  ``intersect_fn`` (``(scene, o, d, alive) ->
    Hit``) overrides the nearest-hit query, as in
    :func:`spira_tpu_torch.integrator.path_trace.trace`."""
    n = origins.shape[0]
    lam = sample_wavelengths(sample_key, n, origins.device)  # (N, W)
    o, d = origins, directions
    throughput = torch.ones_like(lam)
    radiance = torch.zeros_like(lam)
    alive = torch.ones(n, dtype=torch.bool, device=origins.device)
    collapsed = torch.zeros_like(alive)
    for b in range(max_depth):
        o, d, throughput, radiance, alive, collapsed = _bounce(
            (o, d, throughput, radiance, alive, collapsed), b, scene=scene,
            sample_key=sample_key, lam=lam,
            russian_roulette=russian_roulette, intersect_fn=intersect_fn)
    return cl.xyz_to_rgb(cl.spectrum_to_xyz(radiance, lam))


def _bounce(carry, bounce_idx, *, scene, sample_key, lam, russian_roulette,
            intersect_fn=None):
    o, d, throughput, radiance, alive, collapsed = carry
    n = o.shape[0]
    dev = o.device
    materials = scene.materials
    if intersect_fn is None:
        hit = intersect_scene(scene, o, d)
    else:
        hit = intersect_fn(scene, o, d, alive)
    mat = bsdf.gather_materials(materials, hit.material)

    # (N, W) albedo and emission at each carried wavelength
    idx = hit.material.long()
    spd = row_gather.gather_rows(idx, {"albedo": materials.albedo_spd,
                                       "emission": materials.emission_spd})
    alb = cl.sample_spd(spd["albedo"], lam)
    emi = cl.sample_spd(spd["emission"], lam)

    # sky: the RGB gradient upsampled at each ray's wavelengths
    sky_spd = _upsample_device(bsdf.sky_color(d), lam)
    miss = alive & ~hit.hit
    radiance = radiance + torch.where(miss[:, None], throughput * sky_spd,
                                      0.0)
    live_hit = alive & hit.hit
    radiance = radiance + torch.where(live_hit[:, None], throughput * emi,
                                      0.0)

    t_safe = torch.where(hit.hit, hit.t, 1.0)  # keep INF out of backward
    hit_point = o + t_safe[:, None] * d
    entering = vm.dot(d, hit.normal) < 0.0
    n_ff = vm.where(entering, hit.normal, -hit.normal)

    # lobe selection: the hero wavelength decides the geometry
    u = srng.uniform(srng.bounce_key(sample_key, bounce_idx,
                                     srng.Stream.LOBE_SELECT), (n, 3), dev)
    u_lobe, u_trans, u_fresnel = u[:, 0], u[:, 1], u[:, 2]
    specular_sel = u_lobe < mat["metallic"]

    mirror = vm.normalize(vm.reflect(d, n_ff))
    fuzz = srng.unit_vector(srng.bounce_key(sample_key, bounce_idx,
                                            srng.Stream.METAL_FUZZ), (n,),
                            dev)
    fuzzed = vm.normalize(mirror + mat["roughness"][:, None] * fuzz)

    # dispersion: n(λ_hero) = ior + B / λ² (λ in µm)
    lam_hero_um = lam[:, 0] * 1e-3
    ior_hero = mat["ior"] + mat["cauchy_b"] / (lam_hero_um * lam_hero_um)
    eta = torch.where(entering, 1.0 / ior_hero, ior_hero)
    refracted, tir = vm.refract(d, n_ff, eta[:, None])
    refracted = vm.normalize(refracted)
    cos_i = torch.clamp(-vm.dot(d, n_ff), 0.0, 1.0)
    reflect_choice = tir | (u_fresnel < bsdf.schlick(cos_i, ior_hero))
    glass_dir = vm.where(reflect_choice, fuzzed, refracted)

    is_glass = specular_sel & (u_trans < mat["transmission"])
    dispersive = is_glass & ~reflect_choice & (mat["cauchy_b"] > 0.0)
    spec_dir = vm.where(is_glass, glass_dir, fuzzed)
    diffuse_dir = srng.cosine_hemisphere(
        srng.bounce_key(sample_key, bounce_idx, srng.Stream.DIFFUSE_DIR),
        n_ff)
    new_dir = vm.where(specular_sel, spec_dir, diffuse_dir)

    # collapse to the hero on the first dispersive refraction
    do_collapse = dispersive & ~collapsed
    hero_only = device_constant("HERO_ONLY", _HERO_ONLY, dev)
    new_throughput = throughput * alb * torch.where(do_collapse[:, None],
                                                    hero_only, 1.0)
    collapsed = collapsed | do_collapse

    going_out = vm.dot(new_dir, n_ff) >= 0.0
    new_origin = hit_point + SCATTER_EPS * vm.where(going_out, n_ff, -n_ff)

    survived = live_hit
    if russian_roulette:
        new_throughput, survived = russian_roulette_step(
            sample_key, bounce_idx, new_throughput, survived)
    return (vm.where(survived, new_origin, o), vm.where(survived, new_dir, d),
            vm.where(survived, new_throughput, throughput), radiance,
            survived, collapsed)


def _upsample_device(rgb, lam):
    """Smits upsampling on the device: the resampled basis spectra
    sampled at each ray's wavelengths and blended.  rgb (N, 3) in [0,
    scale]; lam (N, W) → (N, W)."""

    def at(name):
        table = device_constant(f"SMITS_{name}", cl._SMITS_RESAMPLED[name],
                                lam.device)
        return cl.sample_spd(table, lam)

    white, cyan, magenta, yellow, red, green, blue = (
        at(k) for k in ("white", "cyan", "magenta", "yellow", "red",
                        "green", "blue"))
    scale = torch.clamp(torch.amax(rgb, dim=-1, keepdim=True), min=1.0)
    rgbn = rgb / scale
    r, g, b = rgbn[:, 0:1], rgbn[:, 1:2], rgbn[:, 2:3]
    # Smits' six orderings of (r, g, b), each blending white with the
    # middle and the top step, the later case winning an overlap
    cases = (
        ((r <= g) & (g <= b), r * white + (g - r) * cyan + (b - g) * blue),
        ((r <= b) & (b < g), r * white + (b - r) * cyan + (g - b) * green),
        ((g < r) & (r <= b), g * white + (r - g) * magenta + (b - r) * blue),
        ((g <= b) & (b < r), g * white + (b - g) * magenta + (r - b) * red),
        ((b < r) & (r <= g), b * white + (r - b) * yellow + (g - r) * green),
        ((b < g) & (g < r), b * white + (g - b) * yellow + (r - g) * red),
    )
    out = torch.zeros_like(white)
    for case, value in cases:
        out = torch.where(case, value, out)
    return torch.clamp(out * scale, min=0.0)
