"""Differentiable inverse rendering: recover material parameters by
gradient descent on an image loss (albedo or albedo SPDs, and light
emission, through path-replay gradients, in an Adam loop).

Counterpart of :mod:`spira_tpu.diff.inverse`.  The estimator is the
wavefront (:func:`spira_tpu_torch.render.accumulate_rows`) under autograd:
the sampling decisions (lobe choice, roulette) are detached, so gradients
flow through the continuous factors only, and each sample is a checkpoint
that the backward replays from its threefry keys.  The optimizer is
``torch.optim.Adam``, whose update ``lr · m̂ / (sqrt(v̂) + eps)`` is
optax's ``adam`` up to the order of rounding.

The sharded step (``mesh=``) raises ``NotImplementedError`` naming
ROADMAP item 16.
"""

from __future__ import annotations

import torch

from ..core import rng as srng
from ..kernels.bvh_megakernel import make_sorted_tile_intersect
from ..kernels.megakernel import true_divide
from ..render import _not_ported, accumulate_rows, with_fields

#: the ``intersect`` forms of :func:`render_for_grad`
INTERSECTS = (None, "packet")


def _sharded():
    return _not_ported("the sharded inverse step (mesh=)",
                       "item 16, parallel/")


def render_for_grad(
    params,
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    semantics: str = "physical",
    spectral: bool = False,
    mesh=None,
    intersect: str | None = None,
):
    """Differentiable render of ``scene`` with material overrides from
    ``params`` (a dict of ``Materials`` field tensors, e.g. albedo and
    emission): the flat (H*W, 3) mean of ``spp`` wavefront samples drawn
    from ``fold_in(base_key(0), seed)``.

    ``intersect="packet"`` takes every bounce's nearest hit from the
    packed-BVH hook in its differentiable form
    (:func:`make_sorted_tile_intersect` with ``grad=True``: CUDA kernel #3
    reports the winner's slot, whose triangle's hit is recomputed under
    autograd), which a packed scene on the card needs: the stackless walk
    of ``intersect_scene`` would synchronise the host every few steps.
    ``None`` takes ``intersect_scene``.
    """
    if mesh is not None:
        raise _sharded()
    if intersect not in INTERSECTS:
        raise ValueError(f"intersect {intersect!r} is none of {INTERSECTS} "
                         "(JAX's 'packet_interpret' is a TPU knob)")
    scene, camera = with_fields(
        scene, camera, {("materials", k): v for k, v in params.items()})
    base = srng.fold_in(srng.base_key(0), seed)
    intersect_fn = (make_sorted_tile_intersect(grad=True)
                    if intersect == "packet" else None)
    acc = accumulate_rows(
        scene, camera, base, width=width, height=height, row_start=0,
        n_rows=height, sample_offset=0, n_samples=spp, max_depth=max_depth,
        semantics=semantics, spectral=spectral, intersect_fn=intersect_fn)
    return true_divide(acc, float(spp))


def mse_loss(rendered, target):
    return torch.mean((rendered - target) ** 2)


def _project(params) -> None:
    """Keep the iterates physical, in place: reflectances in [0, 1],
    emissions at least 0 (and curb drift along an SPD's metamers)."""
    with torch.no_grad():
        for name in ("albedo", "albedo_spd"):
            if name in params:
                params[name].clamp_(0.0, 1.0)
        for name in ("emission", "emission_spd"):
            if name in params:
                params[name].clamp_(min=0.0)


def make_inverse_step(
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    semantics: str = "physical",
    spectral: bool = False,
    learning_rate: float = 2e-2,
    mesh=None,
    intersect: str | None = None,
):
    """Build ``(step, init)`` for the Adam inverse-rendering loop.

    ``init(params)`` makes the tensors of ``params`` (a dict of
    ``Materials`` field overrides, leaf tensors) require grad and returns
    ``torch.optim.Adam`` over them at ``learning_rate``.

    ``step(params, opt_state, scene, camera, target, step_idx) ->
    (params, opt_state, loss)``: the loss of :func:`render_for_grad` at
    seed ``step_idx`` (a fresh Monte-Carlo seed each step) against
    ``target``, its gradients by ``torch.autograd.grad``, one optimizer
    step, then the projections (albedo and albedo SPD clamped to [0, 1],
    emissions to >= 0).  The parameters are updated in place and returned;
    the loss is a detached tensor on the scene's device, so the step
    makes no host sync of its own.
    """
    if mesh is not None:
        raise _sharded()
    def init(params):
        for name, p in params.items():
            if not p.is_leaf:
                raise ValueError(f"parameter {name!r} is not a leaf tensor;"
                                 " pass .detach() of it")
            p.requires_grad_(True)
        return torch.optim.Adam(list(params.values()), lr=learning_rate,
                                foreach=False)

    def step(params, opt_state, scene, camera, target, step_idx):
        img = render_for_grad(
            params, scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=step_idx, semantics=semantics,
            spectral=spectral, intersect=intersect)
        loss = mse_loss(img, target)
        tensors = list(params.values())
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        for p, g in zip(tensors, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        _project(params)
        return params, opt_state, loss.detach()

    return step, init
