"""A triangle mesh through the two-level BVH and its packed tables: the
twin of ``examples/mesh_bvh.py``.  Pass an OBJ path to render it; without
one a subdivided icosphere stands in.  640x360, spp 32, depth 5; on the
card the packed-BVH path tracer renders it.

    python -m spira_tpu_torch.examples.mesh_bvh [model.obj] [out.png]
"""

from __future__ import annotations

import sys

import spira_tpu_torch as sp


def scene_and_camera(aspect: float, obj: str | None = None, device="cuda"):
    scene = sp.attach_packed(sp.create_mesh_scene(obj_path=obj,
                                                  device=device))
    camera = sp.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                            vfov=50.0, aspect_ratio=aspect, device=device)
    return scene, camera


def run(obj: str | None = None, out: str | None = "mesh_render.png", *,
        width: int = 640, height: int = 360, spp: int = 32,
        max_depth: int = 5, seed: int = 0, engine: str = "auto",
        device="cuda"):
    """Render the mesh scene and write it to ``out``; returns the
    (H, W, 3) uint8 image and the triangle count."""
    scene, camera = scene_and_camera(width / height, obj, device)
    img = sp.render(scene, camera, width, height, samples_per_pixel=spp,
                    max_depth=max_depth, seed=seed, engine=engine,
                    output_path=out)
    return img, scene.triangles.count


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    obj = argv[0] if argv and argv[0].endswith(".obj") else None
    out = argv[-1] if argv and argv[-1].endswith(".png") else "mesh_render.png"
    _, count = run(obj, out)
    print(f"wrote {out} ({count} triangles)")


if __name__ == "__main__":
    main()
