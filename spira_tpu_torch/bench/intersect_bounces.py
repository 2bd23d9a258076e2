"""Kernel #3 on each bounce of the wavefront's main path, on the card.

    python3 spira_tpu_torch/bench/intersect_bounces.py [--root DIR]
        [--out PATH]

The inputs are what ``render_flat`` hands #3 (``intersect_tile``) in its
first sample of the bunny (``create_bunny_scene``'s 72,960-triangle
stand-in) at 640x360, depth 4, seed 0: :func:`record_bounces` runs that
sample through ``accumulate_rows`` with the hook's differentiable form
(the slot asked for, ``alive`` as ``active``) and keeps each bounce's
rays, mask and outputs.  For each bounce :func:`time_bounces` reports the
rays, the live share, a digest of the inputs and of #3's outputs, the
time of one call on the card (CUDA events around ``RUN`` calls, over the
count; the median of ``timing.REPEATS`` such runs after a warm-up), and
from ``torch.profiler`` over one call the time of each kernel it
launched.  Whether the outputs are right is ``chip_smoke.py``'s to say:
it holds them against ``intersect_packed_plain`` on the same tensors, to
the bit, and another commit's against this one's by their digests.

``--root`` imports ``spira_tpu_torch`` from another checkout (a ``git
archive`` of another commit unpacked into a directory ``.gitignore``
lists), so that one call on one card times two commits' #3 on the same
inputs (the digests show that they are the same); every commit since the
wavefront was ported takes these calls.  Prints one JSON line (and
appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

SHAPE = dict(width=640, height=360, max_depth=4)
#: calls between two CUDA events: a run long enough that the card, not
#: the host's enqueue of one call, sets the time
RUN = 5


def record_bounces(scene, cam, shape=None, seed=0):
    """The #3 calls of ``render_flat``'s first sample of ``scene`` at
    ``shape``: a list of (origins, dirs, active, outputs), one a bounce."""
    from spira_tpu_torch.core import rng
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.render import accumulate_rows

    shape = dict(SHAPE if shape is None else shape)
    calls = []

    def query(packed, o, d, active=None, with_slot=False):
        out = bk.intersect_tile(packed, o, d, active=active,
                                with_slot=with_slot)
        calls.append((o.clone(), d.clone(), active.clone(), out))
        return out

    accumulate_rows(
        scene, cam, rng.base_key(seed), width=shape["width"],
        height=shape["height"], row_start=0, n_rows=shape["height"],
        sample_offset=0, n_samples=1, max_depth=shape["max_depth"],
        semantics="physical",
        intersect_fn=bk.make_sorted_tile_intersect(grad=True, query=query))
    if len(calls) != shape["max_depth"]:
        raise RuntimeError(f"the sample called #3 {len(calls)} times, not "
                           f"{shape['max_depth']}")
    return calls


def time_bounces(packed, calls):
    """For each recorded call: see the module's docstring."""
    from spira_tpu_torch.bench import timing
    from spira_tpu_torch.bench.mesh_frame import digest, profile_call
    from spira_tpu_torch.kernels import bvh_megakernel as bk

    rows = []
    for bounce, (o, d, active, out) in enumerate(calls):
        def call(o=o, d=d, active=active):
            return bk.intersect_tile(packed, o, d, active=active,
                                     with_slot=True)

        def run(call=call):
            for _ in range(RUN):
                call()

        rows.append(dict(bounce=bounce, rays=o.shape[0],
                         alive=float(active.float().mean()),
                         inputs=digest(o, d, active), outputs=digest(*out),
                         ms=timing.cuda_ms(run) / RUN,
                         kernels_ms=profile_call(call)["kernels_ms"]))
    return rows


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
    import spira_tpu_torch as sp
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import timing

    device = timing.require_cuda("intersect_bounces")
    lib = _build.load("bvh_megakernel")
    scene, _ = sp.create_bunny_scene(allow_download=False, device=device)
    cam = sp.bunny_camera(SHAPE["width"] / SHAPE["height"], device=device)
    rows = time_bounces(scene.packed, record_bounces(scene, cam))
    ptxas = [line.strip() for line in lib.log.splitlines()
             if "registers" in line or "spill" in line
             or "entry function" in line]
    timing.record(args.out, script="intersect_bounces",
                  card=timing.card_line(), root=str(root),
                  shape=SHAPE, bounces=rows,
                  sample_ms=sum(r["ms"] for r in rows), ptxas=ptxas)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
