"""``megakernel_roofline``: kernel #1 (``spira::megakernel``,
``csrc/megakernel.cu``) against the bound of a frame's path work: sphere
tests, hits, misses and camera samples, as the reference counts them on
the checked pixels, scaled to the frame."""

from pbcore import roofline


def read(run):
    if run.traffic.kind != "frames":
        return None
    m = run.cell.mix
    units = roofline.frame_units(run, len(run.cell.config["spheres"]))
    return roofline.share_pct(run, "megakernel", units,
                              12 * m["width"] * m["height"])
