"""``bvh_megakernel_roofline``: kernel #2 (``spira::bvh_megakernel``,
``csrc/bvh_megakernel.cu``) against the bound of a frame's path work
without its tree walk: sphere tests, hits, misses and camera samples, as
the reference counts them on the checked pixels.  The walk's pops depend
on the tree, which a later change may rebuild, so they are not priced:
the share is of a lower bound that reads the same whatever walks the
tree."""

from pbcore import roofline


def read(run):
    if run.traffic.kind != "frames":
        return None
    m = run.cell.mix
    units = roofline.frame_units(run, len(run.cell.config["spheres"]))
    return roofline.share_pct(run, "bvh_megakernel", units,
                              12 * m["width"] * m["height"])
