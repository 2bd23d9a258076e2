"""Tile- and sample-sharded rendering over the ranks of a
``torch.distributed`` world: the twin of ``examples/distributed_render.py``
(640x320, spp 32, depth 4, engine ``fused``).  One process renders alone;
under ``torchrun`` every rank renders its share and rank 0 writes the
gathered frame.  With an even world the spp axis takes 2 ranks and the
tile axis the rest (``n_tile = world // n_spp``).

    python -m spira_tpu_torch.examples.distributed_render
    torchrun --nproc-per-node 4 -m spira_tpu_torch.examples.distributed_render

``--backend gloo`` joins ranks that share a card (NCCL refuses two ranks
on one card).
"""

from __future__ import annotations

import argparse
import sys

import torch

import spira_tpu_torch as sp
from spira_tpu_torch.io import image as img_io
from spira_tpu_torch.parallel import (
    gather_image,
    initialize,
    is_primary,
    make_mesh,
    replicate,
)
from spira_tpu_torch.parallel.mesh import world
from spira_tpu_torch.parallel.sharded import render_flat_sharded


def run(out: str | None = "distributed_render.png", *, width: int = 640,
        height: int = 320, spp: int = 32, max_depth: int = 4, seed: int = 0,
        engine: str = "fused", backend: str | None = None, device="cuda",
        log=print):
    """Join the world (from torchrun's environment), render sharded and
    gather the frame; rank 0 writes it to ``out``.  Returns the flat
    (H*W, 3) HDR frame on every rank, and the mesh."""
    initialize(backend=backend, device=str(device))
    n_dev = world()[1]
    n_spp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(n_tile=n_dev // n_spp, n_spp=n_spp, device=device)
    log(f"mesh: {mesh.shape} over {n_dev} ranks")
    scene = replicate(sp.create_scene(device=device), mesh)
    camera = replicate(sp.default_camera(width / height, device=device),
                       mesh)
    flat = render_flat_sharded(scene, camera, width=width, height=height,
                               mesh=mesh, spp=spp, max_depth=max_depth,
                               seed=seed, engine=engine)
    img = gather_image(flat, mesh)
    if is_primary() and out is not None:
        hdr = img_io.assemble_image(torch.from_numpy(img), width, height)
        img_io.save_png(out, img_io.to_uint8(img_io.tonemap_gamma(hdr)))
    return img, mesh


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backend", default=None,
                        help="the process group's backend (default: NCCL "
                        "for the card's tensors, gloo for the host's)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    out = "distributed_render.png"
    run(out, backend=args.backend)
    if is_primary():
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
