"""Pinhole / thin-lens camera as a dataclass of tensors.

Counterpart of :mod:`spira_tpu.scene.camera`.  The derived frame is stored
as tensors so that camera gradients can flow; v runs bottom-up and images
are flipped at assembly.  ``generate_rays`` serves the wavefront estimator
and comes with that slice.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.device import resolve_device
from ..core.types import tensor_dataclass


@tensor_dataclass
class Camera:
    origin: torch.Tensor  # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,) right axis (for lens sampling)
    v: torch.Tensor  # (3,) up axis
    lens_radius: torch.Tensor  # () aperture/2; 0 = pinhole
    # Static flag set once at construction from the concrete aperture: the
    # tracers pick the 12-field pinhole or 19-field thin-lens raygen by it.
    has_lens: bool = False


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    vfov=60.0,
    aspect_ratio=16.0 / 9.0,
    aperture=0.0,
    focus_dist=None,
    device=None,
) -> Camera:
    """The camera frame as tensors on ``device`` (``None``: the card)."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lookfrom = f32(lookfrom)
    lookat = f32(lookat)
    vup = f32(vup)

    theta = torch.deg2rad(f32(vfov))
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = f32(aspect_ratio) * viewport_height

    w = vm.normalize(lookfrom - lookat)
    u = vm.normalize(vm.cross(vup, w))
    v = vm.cross(w, u)

    focus = f32(1.0 if focus_dist is None else focus_dist)
    horizontal = focus * viewport_width * u
    vertical = focus * viewport_height * v
    llc = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus * w
    return Camera(
        origin=lookfrom,
        lower_left_corner=llc,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=f32(aperture) / 2.0,
        has_lens=bool(aperture > 0.0),
    )


def default_camera(aspect_ratio, device=None) -> Camera:
    """The demo camera: lookfrom (0,1,3), lookat origin, vfov 60, on
    ``device`` (``None``: the card)."""
    return make_camera(
        lookfrom=(0.0, 1.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=60.0,
        aspect_ratio=aspect_ratio,
        device=device,
    )
