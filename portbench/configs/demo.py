"""Builder of the ``demo`` configuration: five spheres, no BVH."""

from pbcore import scenes


def build(cfg, parts, device, aspect_ratio):
    return (scenes.sphere_scene(cfg, device),
            scenes.camera(cfg, aspect_ratio, device))
