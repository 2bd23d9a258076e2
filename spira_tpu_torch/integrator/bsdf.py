"""BSDF sampling (scatter) over a wavefront of hits.

Counterpart of :mod:`spira_tpu.integrator.bsdf`, with the two scatter
models the estimator's ``semantics`` selects:

* ``physical`` — lobe select by ``u < metallic``; metal = mirror +
  roughness · (uniform unit vector); diffuse = cosine-weighted
  hemisphere; a dielectric sub-lobe (Schlick Fresnel reflect/refract)
  with probability ``transmission``.
* ``reference`` — bug-compatible with the reference CPU renderer:
  diffuse = normalize(normal + normalize(box - 0.5)), metal perturbation
  = roughness · (box - 0.5) unnormalized, and diffuse bounces carry 0.5.

Each draw comes from the same ``(bounce, Stream)`` key as in JAX, so the
directions agree with the JAX package's ray for ray.  Everything is
branch-free masked selection.  Material rows are plain gathers, where
JAX takes one-hot matrix products (the same values: 1·x + 0·y = x).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as srng
from ..core import vecmath as vm
from ..core.device import device_constant

_SKY_BLUE = np.asarray([0.5, 0.7, 1.0], np.float32)


def pow5(x):
    """x ** 5 as XLA's integer power multiplies it: x · (x² · x²)."""
    x2 = x * x
    return x * (x2 * x2)


def gather_materials(materials, mat_idx):
    """Per-ray material fields from per-ray 0-based material indices."""
    idx = mat_idx.long()
    cauchy = (materials.cauchy_b if materials.cauchy_b is not None
              else materials.ior * 0.0)
    return {
        "albedo": materials.albedo[idx],
        "emission": materials.emission[idx],
        "metallic": materials.metallic[idx],
        "roughness": materials.roughness[idx],
        "ior": materials.ior[idx],
        "transmission": materials.transmission[idx],
        "cauchy_b": cauchy[idx],
    }


def schlick(cos_i, ior):
    """Schlick's Fresnel reflectance at ``cos_i`` for index ``ior``."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * pow5(1.0 - cos_i)


def scatter_physical(skey, bounce_idx, d_in, normal_out, mat):
    """Sample scatter directions for the faithful model.

    skey: the sample's key; draws are folded with (bounce_idx, stream).
    d_in (N, 3) unit incoming directions; normal_out (N, 3) outward
    geometric normals; mat: gathered material dict.  Returns (new_dir
    (N, 3), attenuation (N, 3)).
    """
    n_rays = d_in.shape[0]
    dev = d_in.device
    entering = vm.dot(d_in, normal_out) < 0.0
    n_ff = vm.where(entering, normal_out, -normal_out)

    u = srng.uniform(srng.bounce_key(skey, bounce_idx,
                                     srng.Stream.LOBE_SELECT), (n_rays, 3),
                     dev)
    u_lobe, u_trans, u_fresnel = u[:, 0], u[:, 1], u[:, 2]
    specular_sel = u_lobe < mat["metallic"]

    mirror = vm.normalize(vm.reflect(d_in, n_ff))
    fuzz = srng.unit_vector(srng.bounce_key(skey, bounce_idx,
                                            srng.Stream.METAL_FUZZ),
                            (n_rays,), dev)
    fuzzed = vm.normalize(mirror + mat["roughness"][:, None] * fuzz)

    # dielectric sub-lobe: with probability `transmission` the specular
    # lobe is glass (Fresnel-weighted reflect/refract) instead of metal
    eta = torch.where(entering, 1.0 / mat["ior"], mat["ior"])
    refracted, tir = vm.refract(d_in, n_ff, eta[:, None])
    refracted = vm.normalize(refracted)
    cos_i = torch.clamp(-vm.dot(d_in, n_ff), 0.0, 1.0)
    reflect_choice = tir | (u_fresnel < schlick(cos_i, mat["ior"]))
    glass_dir = vm.where(reflect_choice, fuzzed, refracted)

    is_glass = specular_sel & (u_trans < mat["transmission"])
    spec_dir = vm.where(is_glass, glass_dir, fuzzed)

    diffuse_dir = srng.cosine_hemisphere(
        srng.bounce_key(skey, bounce_idx, srng.Stream.DIFFUSE_DIR), n_ff)
    return vm.where(specular_sel, spec_dir, diffuse_dir), mat["albedo"]


def scatter_reference(skey, bounce_idx, d_in, normal_out, mat):
    """The bug-compatible scatter of the reference CPU renderer.  Returns
    (new_dir, attenuation); the attenuation includes the 0.5 of diffuse
    bounces."""
    n_rays = d_in.shape[0]
    dev = d_in.device
    u_lobe = srng.uniform(srng.bounce_key(skey, bounce_idx,
                                          srng.Stream.LOBE_SELECT),
                          (n_rays,), dev)
    diffuse_sel = u_lobe > mat["metallic"]  # `rand() > metallic`: diffuse

    box = srng.uniform_box3(srng.bounce_key(skey, bounce_idx,
                                            srng.Stream.DIFFUSE_DIR),
                            (n_rays,), dev) - 0.5
    diffuse_dir = vm.normalize(normal_out + vm.normalize(box))

    fuzz_box = srng.uniform_box3(srng.bounce_key(skey, bounce_idx,
                                                 srng.Stream.METAL_FUZZ),
                                 (n_rays,), dev) - 0.5  # unnormalized
    mirror = vm.reflect(d_in, normal_out)
    metal_dir = vm.normalize(mirror + mat["roughness"][:, None] * fuzz_box)

    new_dir = vm.where(diffuse_sel, diffuse_dir, metal_dir)
    attenuation = torch.where(diffuse_sel[:, None], mat["albedo"] * 0.5,
                              mat["albedo"])
    return new_dir, attenuation


def sky_color(directions):
    """The sky gradient from white at the horizon to blue overhead."""
    t = 0.5 * (directions[..., 1] + 1.0)
    blue = device_constant("SKY_BLUE", _SKY_BLUE, directions.device)
    return (1.0 - t)[..., None] + t[..., None] * blue
