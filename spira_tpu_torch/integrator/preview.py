"""Single-bounce preview shading: the reference's quick-look renderers.

Counterpart of :mod:`spira_tpu.integrator.preview`: one primary-ray
nearest hit against the whole scene and a closed-form shade, with no
bounce loop and no draw beyond the pixel jitter.  ``shading="preview"``
is the headlamp-style direct light ``albedo · max(0.2, n·l)``,
``"normal"`` the normal visualisation ``0.5·(n + 1)``; misses take the sky
gradient.  Reached through ``render(..., shading="preview"|"normal")``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as srng
from ..core.device import device_constant
from ..render import wavefront_hook
from ..scene.camera import generate_rays
from .intersect import intersect_scene

#: the reference's light-from-above direction (∝ (1, 2, 1)), normalised
_LIGHT = (0.40824829, 0.81649658, 0.40824829)
#: the ambient floor of ``max(0.2, n·l)``
_AMBIENT = 0.2
_SKY = (0.5, 0.7, 1.0)


def render_flat_preview(scene, camera, *, width: int, height: int,
                        seed: int = 0, shading: str = "preview",
                        inclusive_uv: bool = True, intersect_fn="auto"):
    """One-bounce shaded render → flat (H*W, 3) bottom-up buffer on the
    scene's device.

    ``intersect_fn`` gives the nearest hit, ``(scene, o, d, alive) ->
    Hit``: ``"auto"`` takes CUDA kernel #3 through
    :func:`spira_tpu_torch.render.wavefront_hook` for a scene with packed
    tables on the card (the stackless walk of ``intersect_scene`` would
    synchronise the host every few steps), else ``intersect_scene``, as
    JAX's preview does everywhere.
    """
    if shading not in ("preview", "normal"):
        raise ValueError(f"unknown preview shading {shading!r}")
    key = srng.sample_key(srng.base_key(seed), 0)
    origins, dirs = generate_rays(camera, width, height, key,
                                  inclusive_uv=inclusive_uv)
    if intersect_fn == "auto":
        intersect_fn = wavefront_hook(scene)
    if intersect_fn is None:
        hit = intersect_scene(scene, origins, dirs)
    else:
        alive = torch.ones(origins.shape[0], dtype=torch.bool,
                           device=origins.device)
        hit = intersect_fn(scene, origins, dirs, alive)

    # face-forward the geometric normal (misses keep a harmless default)
    n = hit.normal
    sgn = torch.where(torch.sum(dirs * n, dim=-1, keepdim=True) < 0.0,
                      1.0, -1.0)
    n = n * sgn

    device = dirs.device
    t_sky = 0.5 * (dirs[:, 1] + 1.0)
    sky = (1.0 - t_sky)[:, None] + t_sky[:, None] * device_constant(
        "preview_sky", np.asarray(_SKY, np.float32), device)
    if shading == "normal":
        shade = 0.5 * (n + 1.0)
    else:
        light = device_constant("preview_light",
                                np.asarray(_LIGHT, np.float32), device)
        lam = torch.clamp(torch.sum(n * light, dim=-1), min=_AMBIENT)
        shade = scene.materials.albedo[hit.material] * lam[:, None]
    return torch.where(hit.hit[:, None], shade, sky)
