"""The program's scene and camera for a configuration, made through the
port's own public constructors from the benchmark's arrays (the ``build``
functions of ``configs/`` call these)."""

from __future__ import annotations


def _sphere_records(cfg):
    return [(tuple(s["center"]), s["radius"], s["material"])
            for s in cfg["spheres"]]


def camera(cfg, aspect_ratio, device):
    from spira_tpu_torch.scene.camera import make_camera

    return make_camera(aspect_ratio=aspect_ratio, device=device,
                       **cfg["camera"])


def sphere_scene(cfg, device):
    """Spheres and materials, brute force (the kernel #1 path), as
    ``scene/scene.py:create_scene`` makes the demo."""
    from spira_tpu_torch.scene.geometry import make_spheres
    from spira_tpu_torch.scene.materials import make_materials
    from spira_tpu_torch.scene.scene import make_scene

    return make_scene(spheres=make_spheres(_sphere_records(cfg), device),
                      materials=make_materials(cfg["materials"], device))


def mesh_scene(cfg, parts, device):
    """Spheres, materials and the mesh ``parts`` ((verts, faces) each)
    under the port's two-level BVH with its packed tables, built on the
    host and moved to ``device``, as ``scene/bunny.py:create_bunny_scene``
    builds the bunny."""
    from spira_tpu_torch.accel.bvh import build_two_level
    from spira_tpu_torch.accel.pairs import attach_packed
    from spira_tpu_torch.scene.geometry import make_spheres, make_triangles
    from spira_tpu_torch.scene.materials import make_materials
    from spira_tpu_torch.scene.scene import make_scene

    material = cfg["mesh"]["material"]
    tris = [make_triangles(v, f, material, device="cpu") for v, f in parts]
    bvh, triangles = build_two_level(tris, leaf_size=cfg["leaf_size"])
    scene = make_scene(
        spheres=make_spheres(_sphere_records(cfg), device="cpu"),
        triangles=triangles,
        materials=make_materials(cfg["materials"], device="cpu"), bvh=bvh)
    return attach_packed(scene).to(device)
