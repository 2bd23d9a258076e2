"""Scene dataclass and the built-in scenes.

Counterpart of :mod:`spira_tpu.scene.scene`.  The built-in scenes are
made on ``device``, the card when it is ``None``
(:func:`spira_tpu_torch.core.device.resolve_device`).  The BVH tables of
the mesh scenes are built on the host (NumPy and the shared C++ builder)
and the finished scene is moved to ``device``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import tensor_dataclass
from .camera import make_camera
from .geometry import (
    Spheres,
    Triangles,
    concat_triangles,
    empty_spheres,
    empty_triangles,
    make_spheres,
    make_triangles,
)
from .materials import Materials, make_materials


@tensor_dataclass
class Scene:
    """spheres + triangle soup + materials.

    ``bvh`` is ``None`` for brute-force intersection, or a
    :class:`spira_tpu_torch.accel.bvh.FlatBVH`; ``packed`` holds the
    pair-record tables the BVH kernels walk
    (:func:`spira_tpu_torch.accel.pairs.attach_packed`); ``wide`` holds a
    16-wide or superleaf packing (:func:`spira_tpu_torch.accel.wide.
    attach_wide`, :func:`spira_tpu_torch.accel.mxu.attach_mxu`,
    :func:`spira_tpu_torch.accel.mxu.attach_superleaf`).
    """

    spheres: Spheres
    triangles: Triangles
    materials: Materials
    bvh: Optional[Any] = None
    packed: Optional[Any] = None
    wide: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.materials.albedo.device


def make_scene(
    spheres=None, triangles=None, materials=None, bvh=None, packed=None,
    wide=None,
) -> Scene:
    """A scene of the given parts; a missing geometry table is made empty
    on the device of the parts given."""
    given = [t for t in (materials and materials.albedo,
                         spheres and spheres.centers,
                         triangles and triangles.v0) if t is not None]
    device = given[0].device if given else None
    return Scene(
        spheres=spheres if spheres is not None else empty_spheres(device),
        triangles=(
            triangles if triangles is not None else empty_triangles(device)
        ),
        materials=materials,
        bvh=bvh,
        packed=packed,
        wide=wide,
    )


def create_scene(device=None) -> Scene:
    """The reference demo scene: diffuse red, grey ground, mirror metal,
    glass-like metal 0.9, white light with emission 5."""
    device = resolve_device(device)
    materials = make_materials(
        [
            dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
            dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
            dict(albedo=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.0),
            dict(albedo=(0.8, 0.8, 1.0), metallic=0.9, roughness=0.0),
            dict(
                albedo=(1.0, 1.0, 1.0),
                emission=(5.0, 5.0, 5.0),
                metallic=0.0,
                roughness=0.0,
            ),
        ],
        device=device,
    )
    spheres = make_spheres(
        [
            ((0.0, 0.0, 0.0), 0.5, 0),
            ((0.0, -100.5, 0.0), 100.0, 1),
            ((1.0, 0.0, 0.0), 0.5, 2),
            ((-1.0, 0.0, 0.0), 0.5, 3),
            ((0.0, 5.0, 0.0), 1.0, 4),
        ],
        device=device,
    )
    return make_scene(spheres=spheres, materials=materials)


def create_cornell_box(light_emission=(15.0, 15.0, 15.0), device=None):
    """Cornell-style box: emissive area light at the ceiling, colored
    diffuse walls, one metal and one dielectric sphere, in a 2×2×2 box
    centered at the origin (12 triangles, 2 spheres)."""
    device = resolve_device(device)
    materials = make_materials(
        [
            dict(albedo=(0.73, 0.73, 0.73)),  # 0 white walls
            dict(albedo=(0.65, 0.05, 0.05)),  # 1 red left wall
            dict(albedo=(0.12, 0.45, 0.15)),  # 2 green right wall
            dict(albedo=(1.0, 1.0, 1.0), emission=light_emission),  # 3 light
            dict(albedo=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.05),  # 4
            dict(  # 5 glass sphere (dielectric, dispersive flint-like glass)
                albedo=(1.0, 1.0, 1.0),
                metallic=1.0,
                roughness=0.0,
                ior=1.5,
                transmission=1.0,
                cauchy_b=0.0042,
            ),
        ],
        device=device,
    )

    def quad(p0, p1, p2, p3, mat):
        verts = np.asarray([p0, p1, p2, p3], np.float32)
        faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
        return make_triangles(verts, faces, mat, device=device)

    s = 1.0  # half-extent
    quads = [
        # floor (normal up)
        quad((-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s), 0),
        # ceiling
        quad((-s, s, -s), (-s, s, s), (s, s, s), (s, s, -s), 0),
        # back wall (z = -s)
        quad((-s, -s, -s), (-s, s, -s), (s, s, -s), (s, -s, -s), 0),
        # left wall (x = -s) red
        quad((-s, -s, s), (-s, s, s), (-s, s, -s), (-s, -s, -s), 1),
        # right wall (x = s) green
        quad((s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s), 2),
        # ceiling light patch
        quad(
            (-0.35, s - 1e-3, -0.35),
            (-0.35, s - 1e-3, 0.35),
            (0.35, s - 1e-3, 0.35),
            (0.35, s - 1e-3, -0.35),
            3,
        ),
    ]
    spheres = make_spheres(
        [
            ((-0.45, -0.7, -0.35), 0.3, 4),  # metal
            ((0.45, -0.7, 0.25), 0.3, 5),  # glass
        ],
        device=device,
    )
    return make_scene(spheres=spheres, triangles=concat_triangles(quads),
                      materials=materials)


def create_mesh_scene(obj_path: str | None = None, subdivisions: int = 3,
                      device=None) -> Scene:
    """The mesh-tier scene: a triangle mesh on a ground sphere under the
    demo light, with a mirror icosphere, traversed through a two-level flat
    BVH.  Loads any OBJ from ``obj_path`` when given, otherwise a subdivided
    icosphere.  Carries ``bvh`` only; pack it with ``attach_packed``."""
    from ..accel.bvh import build_two_level
    from .obj import icosphere, load_obj_mesh

    device = resolve_device(device)
    materials = make_materials(
        [
            dict(albedo=(0.65, 0.55, 0.45), metallic=0.0, roughness=0.6),  # mesh
            dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),  # ground
            dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),  # light
            dict(albedo=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.05),  # mirror
        ],
        device="cpu",
    )
    if obj_path is not None:
        mesh = load_obj_mesh(
            obj_path, material=0, center=True, normalize=True, scale=0.6,
            translate=(0.0, 0.1, 0.0),
        )
    else:
        mesh = icosphere(
            center=(0.0, 0.1, 0.0), radius=0.6, subdivisions=subdivisions,
            material=0,
        )
    mirror = icosphere(center=(1.3, 0.0, -0.6), radius=0.45, subdivisions=2,
                       material=3)
    # leaf size by mesh scale, as the JAX scene: two-row leaves for small
    # trees, one-row leaves for large ones
    n_tris = int(mesh.count) + 320  # + mirror icosphere
    bvh, triangles = build_two_level(
        [mesh, mirror], leaf_size=16 if n_tris < 4000 else 8)
    spheres = make_spheres(
        [
            ((0.0, -100.5, 0.0), 100.0, 1),
            ((0.0, 5.0, 0.0), 1.0, 2),
        ],
        device="cpu",
    )
    scene = make_scene(spheres=spheres, triangles=triangles,
                       materials=materials, bvh=bvh)
    return scene.to(device)


def cornell_camera(aspect_ratio=1.0, device=None):
    """The Cornell box's camera, on ``device`` (``None``: the card)."""
    return make_camera(
        lookfrom=(0.0, 0.0, 3.4),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect_ratio=aspect_ratio,
        device=device,
    )
