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

With a ``mesh`` (:func:`spira_tpu_torch.parallel.mesh.make_mesh`) the
render is split over the ranks' tiles and sample slots as the forward
renderer splits it, and the step all-reduces the replicated parameters'
gradients over every rank before Adam steps, as XLA's backward does for
JAX's ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import rng as srng
from ..kernels.bvh_megakernel import make_sorted_tile_intersect
from ..kernels.megakernel import true_divide
from ..parallel.sharded import sample_slot, sum_over_spp, tile_rows
from ..render import accumulate_rows, with_fields

#: the ``intersect`` forms of :func:`render_for_grad`
INTERSECTS = (None, "packet")


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

    With ``mesh`` it returns this rank's tile, (H/n_tile * W, 3): the
    rows from ``row_start = t * H/n_tile`` at the samples of the rank's
    slot, summed over the tile's ranks, over the whole ``spp``, as JAX's
    shard body computes it.  The sum's backward reaches this rank's own
    samples only: the gradient of a function of the whole image is the
    sum over every rank of each rank's gradient of its tile's share
    (:func:`make_inverse_step` takes it so).
    """
    if intersect not in INTERSECTS:
        raise ValueError(f"intersect {intersect!r} is none of {INTERSECTS} "
                         "(JAX's 'packet_interpret' is a TPU knob)")
    scene, camera = with_fields(
        scene, camera, {("materials", k): v for k, v in params.items()})
    base = srng.fold_in(srng.base_key(0), seed)
    intersect_fn = (make_sorted_tile_intersect(grad=True)
                    if intersect == "packet" else None)
    n_rows, row_start, spp_per, s_off = height, 0, spp, 0
    if mesh is not None:
        n_rows, row_start = tile_rows(mesh, height)
        spp_per, s_off = sample_slot(mesh, spp)
    acc = accumulate_rows(
        scene, camera, base, width=width, height=height,
        row_start=row_start, n_rows=n_rows, sample_offset=s_off,
        n_samples=spp_per, max_depth=max_depth, semantics=semantics,
        spectral=spectral, intersect_fn=intersect_fn)
    if mesh is not None:
        acc = sum_over_spp(acc, mesh)
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

    With ``mesh`` (every rank calls ``init`` and ``step`` alike, with the
    whole (H*W, 3) ``target``): ``init`` broadcasts the parameters from
    rank 0; a step renders the rank's tile, takes the gradient of its
    share of the global MSE (its tile's squared error over the whole
    image's element count), sums the gradients over every rank in one
    all-reduce, and steps, so every rank's parameters stay identical; the
    loss, the global mean, is the tiles' squared errors all-reduced over
    the tile axis.
    """
    def init(params):
        for name, p in params.items():
            if not p.is_leaf:
                raise ValueError(f"parameter {name!r} is not a leaf tensor;"
                                 " pass .detach() of it")
            if mesh is not None and mesh.group is not None:
                dist.broadcast(p.detach(), src=0, group=mesh.group)
            p.requires_grad_(True)
        return torch.optim.Adam(list(params.values()), lr=learning_rate,
                                foreach=False)

    def step(params, opt_state, scene, camera, target, step_idx):
        img = render_for_grad(
            params, scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=step_idx, semantics=semantics,
            spectral=spectral, intersect=intersect, mesh=mesh)
        tensors = list(params.values())
        if mesh is None:
            loss = mse_loss(img, target)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        else:
            loss, grads = sharded_mse_grads(img, target, tensors, mesh)
        for p, g in zip(tensors, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        _project(params)
        return params, opt_state, loss.detach()

    return step, init


def sharded_mse_grads(tile, target, tensors, mesh):
    """The global MSE of a sharded render against the whole (H*W, 3)
    ``target``, and its gradients with respect to ``tensors``: this
    rank's tile's squared error over the whole image's element count, its
    gradients summed over every rank in one all-reduce (each rank's reach
    its own samples, :func:`render_for_grad`), and the loss all-reduced
    over the tile axis.  Returns (loss, gradients), the same on every
    rank; a tensor the render does not reach gets zeros."""
    n_rows = tile.shape[0]
    row_start = mesh.coords[0] * n_rows
    sq = torch.sum((tile - target[row_start:row_start + n_rows]) ** 2)
    grads = torch.autograd.grad(sq / target.numel(), tensors,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tensors, grads)]
    if mesh.group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        grads = [part.view_as(g) for part, g in zip(
            flat.split([g.numel() for g in grads]), grads)]
    sq = sq.detach()
    if mesh.tile_group is not None:
        dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=mesh.tile_group)
    return sq / target.numel(), grads
