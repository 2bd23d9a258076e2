"""The light-transport estimator: a masked wavefront path tracer.

Counterpart of :mod:`spira_tpu.integrator.path_trace`.  Each bounce is one
pass of tensor operations over the whole wavefront; a path that ends stays
in the arrays with its ``alive`` lane cleared, as under JAX's ``lax.scan``.
The bounce loop is a Python loop over a static depth: no boolean-mask
indexing, so no host sync and no data-dependent shape.  Throughput ×
albedo accumulation, emission added every bounce, sky on a miss, Russian
roulette after bounce ``RR_START``, a 0.01 throughput cutoff.

``semantics="reference"`` reproduces the reference CPU renderer in
expectation: an emissive hit ends its path with plain emission, diffuse
bounces carry 0.5, no roulette, no cutoff.

The code keeps the JAX package's differentiable form (``torch.where``
selections, double-where guards, the roulette's probability detached, no
in-place writes to inputs); this slice tests its values only.
"""

from __future__ import annotations

import torch

from ..core import rng as srng
from ..core import vecmath as vm
from ..core.vecmath import SCATTER_EPS
from . import bsdf
from .intersect import intersect_scene

#: bounce index after which Russian roulette starts
RR_START = 3
RR_CAP = 0.95
THROUGHPUT_CUTOFF = 0.01


def trace(scene, origins, directions, sample_key, *, max_depth: int,
          semantics: str = "physical", russian_roulette: bool = True,
          intersect_fn=None):
    """Estimate radiance for a wavefront of rays.

    origins, directions: (N, 3) primary rays (unit directions);
    sample_key: the threefry key already folded with the sample index;
    intersect_fn: nearest-hit override ``(scene, o, d, alive) -> Hit``
    (default :func:`intersect_scene`), e.g. the CUDA #3 hook of
    :func:`spira_tpu_torch.kernels.bvh_megakernel.
    make_sorted_tile_intersect`.  Returns (N, 3) radiance.
    """
    if semantics not in ("physical", "reference"):
        raise ValueError(f"unknown semantics: {semantics!r}")
    o, d = origins, directions
    throughput = torch.ones_like(origins)
    radiance = torch.zeros_like(origins)
    alive = torch.ones(origins.shape[0], dtype=torch.bool,
                       device=origins.device)
    for b in range(max_depth):
        o, d, throughput, radiance, alive = _bounce(
            (o, d, throughput, radiance, alive), b, scene=scene,
            sample_key=sample_key, semantics=semantics,
            russian_roulette=russian_roulette, intersect_fn=intersect_fn)
    return radiance


def russian_roulette_step(sample_key, bounce_idx, new_throughput, survived):
    """Roulette after bounce ``RR_START`` (continue with p = min(max
    channel, 0.95), re-weighted by 1/p) and the throughput cutoff:
    (new_throughput, survived).  The continuation probability is a
    sampling decision, detached from the gradient."""
    if bounce_idx > RR_START:
        p_cont = torch.clamp(torch.amax(new_throughput, dim=-1), 1e-6,
                             RR_CAP).detach()
        u_rr = srng.uniform(
            srng.bounce_key(sample_key, bounce_idx, srng.Stream.ROULETTE),
            (new_throughput.shape[0],), new_throughput.device)
        rr_kill = u_rr > p_cont
        new_throughput = torch.where(~rr_kill[:, None],
                                     new_throughput / p_cont[:, None],
                                     new_throughput)
        survived = survived & ~rr_kill
    return new_throughput, survived & (
        torch.amax(new_throughput, dim=-1) >= THROUGHPUT_CUTOFF)


def _bounce(carry, bounce_idx, *, scene, sample_key, semantics,
            russian_roulette, intersect_fn=None):
    o, d, throughput, radiance, alive = carry
    if intersect_fn is None:
        hit = intersect_scene(scene, o, d)
    else:
        hit = intersect_fn(scene, o, d, alive)
    mat = bsdf.gather_materials(scene.materials, hit.material)

    miss = alive & ~hit.hit
    radiance = radiance + torch.where(miss[:, None],
                                      throughput * bsdf.sky_color(d), 0.0)

    live_hit = alive & hit.hit
    # guarded t: miss lanes carry t = INF, and inf * 0 in the masked
    # branches would still NaN the backward pass
    t_safe = torch.where(hit.hit, hit.t, 1.0)
    hit_point = o + t_safe[:, None] * d

    if semantics == "physical":
        # emission accumulates every bounce through the running
        # throughput; the path continues through emissive surfaces
        radiance = radiance + torch.where(live_hit[:, None],
                                          throughput * mat["emission"], 0.0)
        new_dir, attenuation = bsdf.scatter_physical(
            sample_key, bounce_idx, d, hit.normal, mat)
        entering = vm.dot(d, hit.normal) < 0.0
        n_ff = vm.where(entering, hit.normal, -hit.normal)
        # offset along the side the new direction leaves from (refraction
        # exits through the surface)
        going_out = vm.dot(new_dir, n_ff) >= 0.0
        new_origin = hit_point + SCATTER_EPS * vm.where(going_out, n_ff,
                                                        -n_ff)
        new_throughput = throughput * attenuation
        survived = live_hit
        if russian_roulette:
            new_throughput, survived = russian_roulette_step(
                sample_key, bounce_idx, new_throughput, survived)
    else:
        # emissive surfaces return their emission and end the path
        emissive = torch.any(mat["emission"] > 0.0, dim=-1)
        radiance = radiance + torch.where(
            (live_hit & emissive)[:, None], throughput * mat["emission"],
            0.0)
        new_dir, attenuation = bsdf.scatter_reference(
            sample_key, bounce_idx, d, hit.normal, mat)
        # scattered from the exact hit point: t_min = 1e-3 plays the
        # offset's role
        new_origin = hit_point
        new_throughput = throughput * attenuation
        survived = live_hit & ~emissive

    # dead lanes keep their state (masked update, no compaction)
    return (vm.where(survived, new_origin, o), vm.where(survived, new_dir, d),
            vm.where(survived, new_throughput, throughput), radiance,
            survived)
