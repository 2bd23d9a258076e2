"""``grad_vjp_roofline``: kernel #6's vector-Jacobian product
(``spira::grad_vjp``, ``csrc/grad_megakernel.cu``) against the bound of
its replay: the forward path work of the replayed samples (sphere
tests, hits, misses, camera samples) and the reverse sweep of every
replayed hit, as the reference counts them over the first step's whole
frame at exact replay."""

from pbcore import roofline, sol


def read(run):
    if run.traffic.kind != "steps":
        return None
    w, m = run.work, run.cell.mix
    units = sol.path_units(w["segments"], w["hits"],
                           m["width"] * m["height"] * m["spp"],
                           len(run.cell.config["spheres"]))
    units["adjoint_hit"] = w["hits"]
    return roofline.share_pct(run, "grad_vjp", units,
                              24 * m["width"] * m["height"])
