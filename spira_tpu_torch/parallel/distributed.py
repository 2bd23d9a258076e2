"""Running over many processes: the process group, the rows each rank
owns, and the gather of the image.

Counterpart of :mod:`spira_tpu.parallel.distributed`.  The model:

* :func:`initialize` brings up the default ``torch.distributed`` process
  group from the environment ``torchrun`` sets (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); a
  single-process run, or one whose group exists already, is left alone.
* One mesh spans every rank (:func:`global_mesh`); the sharded renderers
  of :mod:`spira_tpu_torch.parallel.sharded` run the same code on every
  rank, and the only collectives are the all-reduce of the sample sums
  over ``spp`` and the gather of the finished tiles.
* :func:`gather_image` copies each rank's tile to the host and
  all-gathers the tiles there, so every rank (or just the primary, which
  writes the image) holds the whole frame.
* The inverse step's parameters are replicated; their gradients are
  all-reduced over every rank before the optimizer steps
  (:func:`spira_tpu_torch.diff.inverse.make_inverse_step`).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.metrics import logger
from .mesh import Mesh, make_mesh, world

#: the backend :func:`initialize` takes for ranks on cards: NCCL for the
#: tensors on the card, gloo for those on the host (the gathered tiles)
CARD_BACKEND = "cpu:gloo,cuda:nccl"


def initialize(backend: str | None = None, device: str = "cuda",
               timeout: datetime.timedelta | None = None) -> None:
    """Bring up the default process group from the environment (as
    ``torchrun`` sets it), once.  A run with ``WORLD_SIZE`` unset or 1, or
    whose group already exists, is left alone.

    ``device`` says where the ranks render: on ``"cuda"`` each rank takes
    card ``LOCAL_RANK`` as its current device and the backend defaults to
    :data:`CARD_BACKEND`; on ``"cpu"`` it defaults to ``"gloo"``.
    ``backend`` names another (two ranks on one card, which NCCL refuses,
    take ``"gloo"``).  ``timeout`` bounds each collective (the backend's
    default when ``None``).
    """
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        logger.debug("single-process run: no process group")
        return
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", os.environ.get("RANK", "0"))))
    if backend is None:
        backend = CARD_BACKEND if on_card else "gloo"
    kw = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(backend=backend, init_method="env://", **kw)
    logger.info("distributed: rank %d/%d, backend %s",
                dist.get_rank(), dist.get_world_size(), backend)


def global_mesh(n_tile: int | None = None, n_spp: int = 1,
                device=None) -> Mesh:
    """The mesh over every rank of the world (ranks are ordered, so the
    tile axis maps ranks to contiguous row blocks)."""
    return make_mesh(n_tile=n_tile, n_spp=n_spp, device=device)


def host_row_ranges(height: int, mesh: Mesh) -> dict:
    """The rows each rank at ``s == 0`` owns: ``{rank: [(row_start,
    row_end)]}``, rows counted from the bottom; mesh position (t, 0)
    holds the ``height // n_tile`` rows from ``t * height // n_tile``."""
    rows_per = height // mesh.n_tile
    return {int(mesh.ranks[t, 0]): [(t * rows_per, (t + 1) * rows_per)]
            for t in range(mesh.n_tile)}


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tiles of a tile-sharded tensor (this rank's ``local``, the same
    shape on every rank, the same on the ranks of one tile), concatenated
    in tile order along the first axis, on the host of every rank: each
    rank copies its tile to the host and the tiles are all-gathered over
    the mesh there."""
    local = local.detach().to("cpu").contiguous()
    if mesh.group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts[::mesh.n_spp])


def gather_image(flat: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The whole flat (H*W, 3) image as NumPy on every rank, from each
    rank's tile of a tile-sharded render (``render_flat_sharded``'s
    output).  The gather moves only the finished frame: the render itself
    never communicates across tiles."""
    return gather_rows(flat, mesh).numpy()


def is_primary() -> bool:
    """Whether this process is rank 0 (or runs alone): the one that
    writes images and checkpoints."""
    return world()[0] == 0
