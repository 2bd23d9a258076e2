"""Builder of the ``bunny`` configuration: the procedural bunny's parts,
made by the benchmark, under the port's two-level BVH and packed tables."""

from pbcore import scenes


def build(cfg, parts, device, aspect_ratio):
    return (scenes.mesh_scene(cfg, parts, device),
            scenes.camera(cfg, aspect_ratio, device))
