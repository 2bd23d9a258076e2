"""The (tile, spp) mesh over the ranks of a ``torch.distributed`` world,
and the replication of a scene across it.

Counterpart of :mod:`spira_tpu.parallel.mesh`.  The renderer scales along
its two parallel axes:

* ``tile`` — contiguous blocks of pixel rows: each rank of a tile owns
  ``height / n_tile`` rows; the scene, its BVH tables and its spectral
  tables are replicated on every rank;
* ``spp``  — Monte-Carlo samples: the sample range is split over the
  ranks of a tile, and their sums are added with one all-reduce.

Rank ``t * n_spp + s`` holds mesh position ``(t, s)``: the row-major
layout of JAX's ``devices[:n].reshape(n_tile, n_spp)``.  A rank renders
on its own device, which the caller names or which is the rank's current
card; the CPU only when asked for.  A mesh of one rank needs no process
group: its collectives are skipped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of a (tile, spp) mesh: the axes' sizes, its rank and
    position, its device and the process groups it takes part in (``None``
    where the group has one rank, whose collectives are skipped)."""

    n_tile: int
    n_spp: int
    rank: int
    device: torch.device
    group: object = None  # every rank of the mesh
    spp_group: object = None  # the ranks of this rank's tile
    tile_group: object = None  # the ranks at this rank's sample slot

    @property
    def shape(self) -> dict:
        """``{"tile": n_tile, "spp": n_spp}``, as JAX's ``Mesh.shape``."""
        return {"tile": self.n_tile, "spp": self.n_spp}

    @property
    def size(self) -> int:
        return self.n_tile * self.n_spp

    @property
    def ranks(self) -> np.ndarray:
        """(n_tile, n_spp) ranks by position: JAX's ``mesh.devices`` with a
        rank for each device."""
        return np.arange(self.size).reshape(self.n_tile, self.n_spp)

    @property
    def coords(self) -> tuple:
        """This rank's position ``(t, s)``; raises on a rank outside the
        mesh (a world larger than the mesh leaves its last ranks out, as
        JAX leaves out the devices past ``n``)."""
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} is outside the "
                             f"{self.n_tile}x{self.n_spp} mesh")
        return divmod(self.rank, self.n_spp)


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _group(ranks, everyone):
    """The process group of ``ranks`` (``None`` for one rank).  Every rank
    of the world calls it for every group, in the same order, as
    ``dist.new_group`` requires."""
    if len(ranks) == 1:
        return None
    if len(ranks) == everyone:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(n_tile: int | None = None, n_spp: int = 1,
              device=None) -> Mesh:
    """Build a (tile, spp) mesh over the ranks of the default process
    group (one rank without one).  ``n_tile`` defaults to every rank on
    the tile axis; a mesh larger than the world raises ``ValueError``.
    ``device`` is where this rank renders: by default its current card
    (``torch.cuda.current_device()``, which :func:`spira_tpu_torch.
    parallel.distributed.initialize` sets to the rank's local card);
    asking for the card on a host without one raises.  Every rank of the
    world calls it with the same axes."""
    rank, n_world = world()
    if n_tile is None:
        n_tile = n_world // n_spp
    n = n_tile * n_spp
    if n_tile < 1 or n_spp < 1 or n > n_world:
        raise ValueError(
            f"mesh {n_tile}x{n_spp} needs {n} ranks, have {n_world}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    grid = np.arange(n).reshape(n_tile, n_spp)
    group = _group(range(n), n_world)
    spp_groups = [_group(grid[t], n_world) for t in range(n_tile)]
    tile_groups = [_group(grid[:, s], n_world) for s in range(n_spp)]
    mine = divmod(rank, n_spp) if rank < n else None
    return Mesh(
        n_tile=n_tile, n_spp=n_spp, rank=rank, device=device, group=group,
        spp_group=spp_groups[mine[0]] if mine else None,
        tile_group=tile_groups[mine[1]] if mine else None)


def _tree_map(fn, obj):
    """``fn`` applied to every tensor of ``obj`` (a tensor, or a dataclass
    of tensors, nested dataclasses and other values, which are kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a scene, a camera) on the rank's device,
    broadcast from rank 0 over the mesh, so that every rank holds rank 0's
    tables; the BASELINE layout: the scene replicated on every chip."""

    def put(t):
        if mesh.group is None:
            return t.to(mesh.device)
        # a copy: the broadcast writes into it on every rank but 0
        t = t.to(mesh.device, memory_format=torch.contiguous_format,
                 copy=True)
        dist.broadcast(t, src=0, group=mesh.group)
        return t

    return _tree_map(put, tree)
