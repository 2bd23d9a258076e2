"""Tile- and sample-sharded rendering over a (tile, spp) mesh of ranks.

Counterpart of :mod:`spira_tpu.parallel.sharded`.  The image's pixel rows
are split over the ``tile`` axis and the Monte-Carlo samples over the
``spp`` axis; the scene is replicated (:func:`spira_tpu_torch.parallel.
mesh.replicate`).  Each rank traces its rows and samples alone, with no
collective during the trace; then one all-reduce (SUM) adds the sample
sums over the ranks of a tile, and the mean divides by the whole ``spp``,
as JAX's ``psum(acc, "spp") / spp`` does.  A rank returns its tile,
(H/n_tile * W, 3); :func:`spira_tpu_torch.parallel.distributed.
gather_image` assembles the frame.

The shard bodies, by engine (JAX's names in brackets):

* ``fused`` (``fused``) — :func:`spira_tpu_torch.kernels.megakernel.
  fused_rows`, the plain tracer over the rank's rows, on any device;
* ``cuda_bvh`` / ``cuda_bvh_mxu`` (``pallas_bvh`` / ``pallas_bvh_mxu``) —
  :func:`spira_tpu_torch.kernels.bvh_megakernel.bvh_rows`: kernel #2 (its
  superleaf form) once a shard on the card, its plain version on the CPU;
* ``wavefront`` — :func:`spira_tpu_torch.render.accumulate_rows` with
  :func:`spira_tpu_torch.render.wavefront_hook` (kernel #3 a bounce on a
  packed scene on the card);
* ``bvh_sorted`` — the same with the packed-BVH query's hook on any
  device.

Two kinds of sharding invariance, as in JAX.  ``fused`` and ``cuda_bvh*``
key PCG on the global pixel and sample: with the samples unsplit and a
power-of-two ``spp`` their image is the unsharded image to the bit (a
split of the samples adds the same samples in another order).  The
wavefront draws sample ``k`` of the rows from ``row_start`` from
``fold_in(sample_key(base, k), row_start)``, so its tiles draw other
randomness than the unsharded frame, as JAX's do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import rng as srng
from ..io import image as img_io
from ..kernels.bvh_megakernel import bvh_rows, make_sorted_tile_intersect
from ..kernels.megakernel import _uv_scale, fused_rows, true_divide
from ..render import (
    _unknown_engine,
    accumulate_row_set,
    accumulate_rows,
    wavefront_hook,
)
from .distributed import gather_image
from .mesh import Mesh

#: the shard bodies' engines (JAX's ``pallas_bvh*`` named ``cuda_bvh*``)
ENGINES = ("fused", "cuda_bvh", "cuda_bvh_mxu", "wavefront", "bvh_sorted")
#: the engines that key PCG on the global pixel and sample (RGB, physical)
_KERNEL_ENGINES = ("fused", "cuda_bvh", "cuda_bvh_mxu")


class _SumOverSpp(torch.autograd.Function):
    """The all-reduce (SUM) of a tile's sample sums over the ranks of the
    tile.  Its backward is the identity: each rank's gradient reaches its
    own samples only, and the gradients are summed over every rank once,
    afterwards (:func:`spira_tpu_torch.diff.inverse.make_inverse_step`);
    an all-reduce in the backward too would count them ``n_spp`` times."""

    @staticmethod
    def forward(ctx, acc, group):
        out = acc.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_spp(acc: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``acc`` summed over the ranks of this rank's tile: one all-reduce
    (none on a tile of one rank)."""
    if mesh.spp_group is None:
        return acc
    return _SumOverSpp.apply(acc, mesh.spp_group)


def tile_rows(mesh: Mesh, height: int, what: str = "height"):
    """This rank's rows of ``height``: (n_rows, row_start); JAX's
    ``ValueError`` where ``height`` does not divide by the tile axis."""
    if height % mesh.n_tile:
        raise ValueError(f"{what} {height} not divisible by tile axis "
                         f"{mesh.n_tile}")
    per = height // mesh.n_tile
    return per, mesh.coords[0] * per


def sample_slot(mesh: Mesh, n_samples: int, what: str = "spp"):
    """This rank's samples of ``n_samples``: (count, offset); JAX's
    ``ValueError`` where ``n_samples`` does not divide by the spp axis."""
    if n_samples % mesh.n_spp:
        raise ValueError(f"{what} {n_samples} not divisible by spp axis "
                         f"{mesh.n_spp}")
    per = n_samples // mesh.n_spp
    return per, mesh.coords[1] * per


def _check_engine(engine, semantics, spectral):
    if engine not in ENGINES:
        raise ValueError(_unknown_engine(engine, ENGINES))
    if engine != "wavefront" and semantics != "physical":
        raise ValueError(f"engine {engine!r} renders physical semantics "
                         "only; use engine='wavefront' for reference "
                         "semantics")
    if engine in _KERNEL_ENGINES and spectral:
        raise ValueError(f"engine {engine!r} renders RGB only; use "
                         "engine='wavefront' for spectral transport")


def _shard_sum(scene, camera, *, engine, width, height, n_rows, row_start,
               sample_offset, n_samples, max_depth, seed, semantics,
               inclusive_uv, spectral):
    """The sum of ``n_samples`` samples from ``sample_offset`` on over the
    ``n_rows`` rows from ``row_start``: (n_rows*width, 3)."""
    if engine == "fused":
        du, dv = _uv_scale(width, height, inclusive_uv)
        return fused_rows(scene, camera, width=width, n_rows=n_rows,
                          row_start=row_start, sample_offset=sample_offset,
                          spp=n_samples, max_depth=max_depth, seed=seed,
                          du=du, dv=dv)
    if engine.startswith("cuda_bvh"):
        return bvh_rows(scene, camera, width=width, height=height,
                        n_rows=n_rows, row_start=row_start,
                        sample_offset=sample_offset, spp=n_samples,
                        max_depth=max_depth, seed=seed,
                        inclusive_uv=inclusive_uv,
                        mxu_leaf=engine == "cuda_bvh_mxu")
    return accumulate_rows(
        scene, camera, srng.base_key(seed), width=width, height=height,
        row_start=row_start, n_rows=n_rows, sample_offset=sample_offset,
        n_samples=n_samples, max_depth=max_depth, semantics=semantics,
        inclusive_uv=inclusive_uv, spectral=spectral,
        intersect_fn=_sorted_intersect(scene, engine, semantics))


def _sorted_intersect(scene, engine, semantics):
    """The wavefront shard body's nearest-hit hook: the packed-BVH query's
    for ``bvh_sorted`` (JAX's sorted-packet traversal), else the
    wavefront's own (:func:`spira_tpu_torch.render.wavefront_hook`)."""
    if engine != "bvh_sorted":
        return wavefront_hook(scene, semantics)
    if scene.packed is None:
        raise ValueError("engine 'bvh_sorted' needs scene.packed; call "
                         "spira_tpu_torch.accel.pairs.attach_packed")
    return make_sorted_tile_intersect()


def render_chunk_sharded(scene, camera, sample_offset: int, *, width: int,
                         height: int, mesh: Mesh, n_samples: int,
                         max_depth: int = 4, seed: int = 0,
                         semantics: str = "physical",
                         inclusive_uv: bool = True, spectral: bool = False,
                         engine: str = "wavefront") -> torch.Tensor:
    """The radiance **sum** of global samples ``sample_offset ..
    sample_offset + n_samples - 1`` over this rank's tile, (H/n_tile * W,
    3), summed over the tile's ranks: the shard body of the sharded
    progressive renderer.  Randomness is keyed on absolute sample indices, so
    the chunks of a render add up to its one-shot sums."""
    return _sharded_sum(scene, camera, sample_offset, n_samples, "chunk",
                        width=width, height=height, mesh=mesh,
                        max_depth=max_depth, seed=seed, semantics=semantics,
                        inclusive_uv=inclusive_uv, spectral=spectral,
                        engine=engine)


def _sharded_sum(scene, camera, sample_offset, n_samples, what, *, mesh,
                 engine, semantics, spectral, height, **kw):
    _check_engine(engine, semantics, spectral)
    n_rows, row_start = tile_rows(mesh, height)
    spp_per, s_off = sample_slot(mesh, n_samples, what)
    acc = _shard_sum(scene, camera, engine=engine, height=height,
                     n_rows=n_rows, row_start=row_start,
                     sample_offset=sample_offset + s_off, n_samples=spp_per,
                     semantics=semantics, spectral=spectral, **kw)
    return sum_over_spp(acc, mesh)


def render_flat_sharded(scene, camera, *, width: int, height: int,
                        mesh: Mesh, spp: int = 16, max_depth: int = 4,
                        seed: int = 0, semantics: str = "physical",
                        inclusive_uv: bool = True, spectral: bool = False,
                        engine: str = "wavefront") -> torch.Tensor:
    """This rank's tile of the flat bottom-up HDR frame, the mean of
    ``spp`` samples: (H/n_tile * W, 3) on the mesh's device; every rank
    of a tile holds the same tile.  ``height`` must divide by the tile
    axis and ``spp`` by the spp axis.  ``engine``: one of :data:`ENGINES`
    (``cuda_bvh`` needs ``attach_packed``, ``cuda_bvh_mxu``
    ``attach_superleaf``)."""
    acc = _sharded_sum(scene, camera, 0, spp, "spp", width=width,
                       height=height, mesh=mesh, max_depth=max_depth,
                       seed=seed, semantics=semantics,
                       inclusive_uv=inclusive_uv, spectral=spectral,
                       engine=engine)
    return true_divide(acc, float(spp))


def render_hdr_sharded(scene, camera, width: int, height: int, mesh: Mesh,
                       **kw) -> torch.Tensor:
    """The whole (H, W, 3) top-down HDR frame on the host of every rank:
    :func:`render_flat_sharded`'s tiles gathered and assembled."""
    flat = render_flat_sharded(scene, camera, width=width, height=height,
                               mesh=mesh, **kw)
    return img_io.assemble_image(torch.from_numpy(gather_image(flat, mesh)),
                                 width, height)


def accumulate_row_set_sharded(scene, camera, base_key, rows, sample_base,
                               *, width: int, height: int, n_samples: int,
                               max_depth: int, mesh: Mesh,
                               semantics: str = "physical",
                               spectral: bool = False, intersect_fn=None):
    """:func:`spira_tpu_torch.render.accumulate_row_set` over a mesh: the
    row set ``rows`` (every rank passes the whole set; its length divides
    by the tile axis) split into contiguous slices over the tiles and the
    ``n_samples`` samples over the tile's ranks.  Tile ``t`` draws from
    ``fold_in(base_key, t)``, as JAX's row-set shards do, so the tiles
    draw decorrelated randomness.  Returns this rank's ``(acc, lum,
    lum2)`` for its slice of the set, summed over the tile's ranks by one
    all-reduce."""
    rows = torch.as_tensor(rows)
    per, first = tile_rows(mesh, rows.shape[0], "row set")
    per_spp, s_off = sample_slot(mesh, n_samples, "round size")
    acc, lum, lum2 = accumulate_row_set(
        scene, camera, srng.fold_in(base_key, mesh.coords[0]),
        rows[first:first + per],
        sample_base + s_off, width=width, height=height, n_samples=per_spp,
        max_depth=max_depth, semantics=semantics, spectral=spectral,
        intersect_fn=intersect_fn)
    n = lum.shape[0]
    both = sum_over_spp(torch.cat([acc, lum[:, None], lum2[:, None]], 1),
                        mesh)
    return both[:, :3], both[:, 3].reshape(n), both[:, 4].reshape(n)
