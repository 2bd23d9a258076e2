"""Times of the mesh path tracers (#2, #5) and the kernels that share
their walk (#3, #2b) on the card.

    python3 spira_tpu_torch/bench/mesh_frame.py [--root DIR] [--out PATH]

The bunny (``create_bunny_scene``'s 72,960-triangle stand-in) at 640x360,
spp 16, depth 4, the shape of a serving frame.  Timed with CUDA events
(``timing.cuda_ms``: a warm-up, then the median of 10): the wrappers of
#2 (``render_flat_bvh_megakernel``) and #5
(``render_flat_spectral_bvh_megakernel``), #2b
(``render_flat_bvh_mxu_megakernel`` on ``attach_superleaf``'s tree) and
#3 (``intersect_tile`` on the 230,400 primary rays).  Then
``torch.profiler``'s time on the card by kernel name over 5 calls of #2
and of #5, ``ptxas -v`` of the library that holds each kernel, and a
SHA-256 digest of each output's bytes, so that two commits' images can be
held equal to the bit.

``--root`` imports ``spira_tpu_torch`` from another checkout (a ``git
archive`` of another commit unpacked into a directory ``.gitignore``
lists), so that one call on one card times two commits' kernels with the
same script; the calls it makes have the same signatures at every commit
since the superleaf engines were ported.  Prints one JSON line (and
appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
#: the libraries the timed kernels live in
LIBRARIES = ("bvh_megakernel", "spectral_megakernel")


def primary_rays(cam, width, height):
    """Pinhole rays through the pixel centres, bottom-up rows: (N, 3)
    origins and unit directions."""
    dev = cam.origin.device
    v = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5) / height
    u = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5) / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = (cam.lower_left_corner + uu.reshape(-1, 1) * cam.horizontal
         + vv.reshape(-1, 1) * cam.vertical - cam.origin)
    d = d / d.norm(dim=1, keepdim=True)
    return cam.origin.expand_as(d).contiguous(), d.contiguous()


def digest(*tensors):
    """SHA-256 (16 hex digits) of the tensors' bytes, on the host."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(device):
    """The times above, for the ``spira_tpu_torch`` on ``sys.path``."""
    import spira_tpu_torch as sp
    from spira_tpu_torch.bench.grad_step import kernels_ms
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import spectral_bvh as sb

    w, h = SHAPE["width"], SHAPE["height"]
    bunny, _ = sp.create_bunny_scene(allow_download=False, device=device)
    bunny_sl = sp.attach_superleaf(bunny)
    cam = sp.bunny_camera(w / h, device=device)
    rays = primary_rays(cam, w, h)
    calls = dict(
        bvh_megakernel=lambda: bk.render_flat_bvh_megakernel(bunny, cam,
                                                             **SHAPE),
        spectral_bvh_megakernel=lambda: (
            sb.render_flat_spectral_bvh_megakernel(bunny, cam, **SHAPE)),
        bvh_mxu_megakernel=lambda: bk.render_flat_bvh_mxu_megakernel(
            bunny_sl, cam, **SHAPE),
        bvh_intersect=lambda: bk.intersect_tile(bunny.packed, *rays,
                                                with_slot=True),
    )
    outs = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    return dict(
        ms={name: cuda_ms(fn) for name, fn in calls.items()},
        kernels_ms={name: kernels_ms(calls[name])
                    for name in ("bvh_megakernel", "spectral_bvh_megakernel")},
        digest={name: digest(*(out if isinstance(out, tuple) else (out,)))
                for name, out in outs.items()},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="the checkout whose spira_tpu_torch to time "
                    "(default: this one)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import timing

    device = timing.require_cuda("mesh_frame")
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(_build.load, LIBRARIES)))
    times = measure(device)
    # ptxas -v of the libraries (built by this process unless the checkout
    # had them cached)
    ptxas = {name: [line.strip() for line in lib.log.splitlines()
                    if "registers" in line or "spill" in line
                    or "entry function" in line]
             for name, lib in libs.items()}
    sources = sorted((root / "spira_tpu_torch" / "csrc").glob("*.cu*"))
    h = hashlib.sha256()
    for path in sources:
        h.update(path.read_bytes())
    timing.record(args.out, script="mesh_frame", card=timing.card_line(),
                  root=str(root), csrc_sha256=h.hexdigest()[:16],
                  shape=SHAPE, ptxas=ptxas, **times)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
