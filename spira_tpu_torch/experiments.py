"""The retired superleaf engines, kept callable: counterpart of
:mod:`spira_tpu.experiments`.

Two engines replace the packed-BVH kernel's row leaves with 128-triangle
Plücker blocks (:mod:`spira_tpu_torch.accel.mxu`): ``cuda_bvh_mxu`` walks
a pair tree whose leaves are blocks, ``cuda_mxu`` streams every block
with no tree.  The JAX package measured both slower than its packet-BVH
engine on its accelerator; ``PERF.md`` has the port's own times on the
H100 beside ``cuda_bvh`` on the same scenes and seeds.  Same estimator and
PCG stream as the production engines::

    from spira_tpu_torch.experiments import render_flat_bvh_mxu, render_flat_mxu

    img = render_flat_bvh_mxu(scene, camera, width=W, height=H)   # superleaf
    img = render_flat_mxu(scene, camera, width=W, height=H)       # streaming

Both attach their block packings on first use (``attach_superleaf`` /
``attach_mxu``); do that once outside a render loop for repeated calls.
"""

from __future__ import annotations


def render_flat_bvh_mxu(scene, camera, **kw):
    """Packed-BVH walk with superleaf leaves (engine ``cuda_bvh_mxu``)."""
    from .render import render_flat_engine

    return render_flat_engine(scene, camera, engine="cuda_bvh_mxu", **kw)


def render_flat_mxu(scene, camera, **kw):
    """Streaming superleaf path tracer (engine ``cuda_mxu``)."""
    from .render import render_flat_engine

    return render_flat_engine(scene, camera, engine="cuda_mxu", **kw)
