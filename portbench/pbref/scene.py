"""The reference's scene: a configuration's spheres, materials, triangles
and camera as plain tensors, worked out from the configuration file and
the benchmark's own mesh arrays.  The camera frame is the arithmetic of
``spira_tpu_torch/scene/camera.py:make_camera`` at commit 86df806.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from . import vec

_MATERIAL_DEFAULTS = dict(emission=(0.0, 0.0, 0.0), metallic=0.0,
                          roughness=0.5, ior=1.0, transmission=0.0)


@dataclass
class Scene:
    centers: torch.Tensor  # (S, 3)
    radii: torch.Tensor  # (S,)
    sphere_mat: torch.Tensor  # (S,) int64
    materials: dict  # albedo, emission (M, 3); metallic ... (M,)
    tris: dict = field(default_factory=dict)  # v0 e1 e2 normal, material
    bvh: object = None

    @property
    def dtype(self):
        return self.centers.dtype

    def with_materials(self, **fields):
        return replace(self, materials={**self.materials, **fields})


@dataclass
class Camera:
    origin: torch.Tensor
    llc: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor


def make_scene(cfg, tri_arrays, device, dtype=torch.float32):
    """The scene of configuration ``cfg`` (its ``spheres`` and
    ``materials`` lists) with the triangles of ``tri_arrays``
    (:func:`pbref.mesh.triangle_arrays`), in ``dtype`` on ``device``."""
    def f(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).to(dtype)

    mats = [{**_MATERIAL_DEFAULTS, **m} for m in cfg["materials"]]
    materials = {k: f([m[k] for m in mats]) for k in
                 ("albedo", "emission", "metallic", "roughness", "ior",
                  "transmission")}
    sph = cfg["spheres"]
    tris = {}
    if tri_arrays and len(tri_arrays["v0"]):
        tris = {k: f(tri_arrays[k]) for k in ("v0", "e1", "e2", "normal")}
        tris["material"] = torch.as_tensor(tri_arrays["material"],
                                           device=device).long()
    return Scene(
        centers=f([s["center"] for s in sph]).reshape(-1, 3),
        radii=f([s["radius"] for s in sph]),
        sphere_mat=torch.as_tensor([s["material"] for s in sph],
                                   device=device).long(),
        materials=materials, tris=tris)


def make_camera(cam, aspect_ratio, device, dtype=torch.float32) -> Camera:
    """The camera frame of ``cam`` (lookfrom, lookat, vup, vfov) at
    ``aspect_ratio``, computed in float32 and cast to ``dtype``."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lookfrom = f32(cam["lookfrom"])
    lookat = f32(cam["lookat"])
    vup = f32(cam.get("vup", (0.0, 1.0, 0.0)))
    theta = torch.deg2rad(f32(cam["vfov"]))
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = f32(aspect_ratio) * viewport_height
    w = vec.normalize(lookfrom - lookat)
    u = vec.normalize(vec.cross(vup, w))
    v = vec.cross(w, u)
    focus = f32(1.0)
    horizontal = focus * viewport_width * u
    vertical = focus * viewport_height * v
    llc = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus * w
    out = Camera(origin=lookfrom, llc=llc, horizontal=horizontal,
                 vertical=vertical, u=u, v=v,
                 lens_radius=f32(cam.get("aperture", 0.0)) / 2.0)
    return Camera(**{k: getattr(out, k).to(dtype)
                     for k in out.__dataclass_fields__})
