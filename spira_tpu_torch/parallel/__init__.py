"""Rendering over a (tile, spp) mesh of ``torch.distributed`` ranks: the
mesh (:mod:`.mesh`), the process group and the gathers
(:mod:`.distributed`) and the sharded renderers (:mod:`.sharded`).
Counterpart of :mod:`spira_tpu.parallel`."""

from .distributed import (
    gather_image,
    global_mesh,
    host_row_ranges,
    initialize,
    is_primary,
)
from .mesh import Mesh, make_mesh, replicate
from .sharded import (
    accumulate_row_set_sharded,
    render_chunk_sharded,
    render_flat_sharded,
    render_hdr_sharded,
)

__all__ = [
    "Mesh",
    "accumulate_row_set_sharded",
    "gather_image",
    "global_mesh",
    "host_row_ranges",
    "initialize",
    "is_primary",
    "make_mesh",
    "render_chunk_sharded",
    "render_flat_sharded",
    "render_hdr_sharded",
    "replicate",
]
