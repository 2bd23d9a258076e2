"""Pinhole / thin-lens camera as a dataclass of tensors.

Counterpart of :mod:`spira_tpu.scene.camera`.  The derived frame is stored
as tensors so that camera gradients can flow; v runs bottom-up and images
are flipped at assembly.  :func:`generate_rays` makes the wavefront
estimator's threefry-jittered primary rays.
"""

from __future__ import annotations

import math

import torch

from ..core import rng as srng
from ..core import vecmath as vm
from ..core.device import resolve_device
from ..core.types import tensor_dataclass
from ..kernels.megakernel import true_divide


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


def generate_rays(camera: Camera, width: int, height: int, key, *,
                  inclusive_uv: bool = True, row_start: int = 0,
                  n_rows: int | None = None):
    """Jittered primary rays for the rows ``row_start .. row_start +
    n_rows`` (all rows by default), flattened to an (n_rows*W,) wavefront
    on the camera's device: (origins (N, 3), directions (N, 3)).

    Ray ``r = (row - row_start) * W + col``, ``row`` counting from the
    bottom of the image.  ``key`` (:mod:`spira_tpu_torch.core.rng`) is the
    sample's key; the jitter draws from its ``PIXEL_JITTER`` stream and
    the thin-lens disk from ``LENS``.  ``inclusive_uv=True`` divides by
    (dim - 1), ``False`` by dim.  The JAX package's row-set and block-set
    forms (``rows=``, ``blocks=``) are not ported.
    """
    if n_rows is None:
        n_rows = height
    n = width * n_rows
    device = camera.origin.device
    jitter = srng.uniform(srng.bounce_key(key, 0, srng.Stream.PIXEL_JITTER),
                          (n, 2), device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    col = (idx % width).to(torch.float32)
    row = (idx // width + row_start).to(torch.float32)
    return _rays_from_uv(camera, width, height, key, jitter, col, row,
                         inclusive_uv, n)


def _rays_from_uv(camera, width, height, key, jitter, col, row,
                  inclusive_uv, n):
    du = float(width - 1 if inclusive_uv else width)
    dv = float(height - 1 if inclusive_uv else height)
    u = true_divide(col + jitter[:, 0], du)
    v = true_divide(row + jitter[:, 1], dv)

    target = (camera.lower_left_corner[None, :]
              + u[:, None] * camera.horizontal[None, :]
              + v[:, None] * camera.vertical[None, :])

    origins = camera.origin[None, :].expand(n, 3)
    if camera.has_lens:
        # polar disk sample; a pinhole (lens_radius 0) adds exactly 0
        disk = srng.uniform(srng.bounce_key(key, 0, srng.Stream.LENS),
                            (n, 2), camera.origin.device)
        r = torch.sqrt(disk[:, 0])
        phi = 2.0 * math.pi * disk[:, 1]
        lens_offset = (camera.lens_radius * r)[:, None] * (
            torch.cos(phi)[:, None] * camera.u[None, :]
            + torch.sin(phi)[:, None] * camera.v[None, :])
        origins = origins + lens_offset
    directions = vm.normalize(target - origins)
    return origins, directions
