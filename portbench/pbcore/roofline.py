"""A kernel's share of its roofline: the least time the card could take
for the work of one launch (:mod:`pbcore.sol`, priced over units the
reference counted) over the launch's mean time on the card (the traced
window's device records of the kernel, by name)."""

from __future__ import annotations

import re

from . import sol


def kernel_matcher(kernel: str):
    """Accepts the device records of ``spira::<kernel>`` and of no other
    kernel whose name begins so."""
    pattern = re.compile(r"spira::" + re.escape(kernel) + r"(?![A-Za-z0-9_])")
    return lambda name: bool(pattern.search(name))


def launch_seconds(run, kernel: str):
    """Mean seconds on the card of one launch of ``kernel`` in the traced
    window, or None where it never ran."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(kernel_matcher(kernel))
    return seconds / launches if launches else None


def share_pct(run, kernel: str, units: dict, nbytes: float):
    """100 × bound / launch time, or None where either is missing."""
    measured = launch_seconds(run, kernel)
    if measured is None or not run.rates or not run.work.get("segments"):
        return None
    bound = sol.lower_bound_seconds(units, nbytes, run.rates["alu_per_s"])
    return 100.0 * bound["bound_s"] / measured


def frame_units(run, n_spheres: int) -> dict:
    """Units of one frame of a frames cell without its tree walk: the
    reference's segments and hits on the checked pixels, scaled to the
    frame's samples."""
    w, m = run.work, run.cell.mix
    return sol.path_units(w["segments"] * w["scale"], w["hits"] * w["scale"],
                          m["width"] * m["height"] * m["spp"], n_spheres)
