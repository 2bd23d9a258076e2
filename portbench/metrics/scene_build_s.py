"""``scene_build_s``: seconds of the scene's build in set-up, on the
host's clock: the port's constructors, its BVH and packed tables, the
move to the card."""


def read(run):
    return run.setup.get("scene_build_s")
