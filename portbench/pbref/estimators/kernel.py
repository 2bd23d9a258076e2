"""``kernel``: the estimator of the kernels' frames (#1 over spheres, #2
over a BVH): each (pixel, sample) a PCG path keyed by pixel, sample and
seed, the pixel the mean of its samples (:func:`pbref.tracer.
render_pixels`)."""

from pbref.tracer import render_pixels  # noqa: F401
