"""Where a wavefront frame's time goes on the card.

    python3 -m spira_tpu_torch.bench.wavefront_frame [--out PATH]

The frame is ``render_flat`` (the wavefront estimator, the engine
``wavefront``) on the bunny (``create_bunny_scene``'s 72,960-triangle
stand-in) at 640x360, spp 16, depth 4, whose every bounce takes its
nearest hits from kernel #3 (``intersect_tile``).  :func:`breakdown`
reports:

* the wrapper's time with CUDA events (``timing.cuda_ms``: a warm-up,
  then the median of ``runs``);
* from ``torch.profiler`` over one call: the time on the card in all and
  by kernel, #3's launches and its time a launch and share of the device
  time (an error if the trace shows no #3), and the device operations of
  the call by kind; the card's idle share of the wrapper's time (1 -
  device / wrapper), and of the profiled call's window, which the
  profiler's own cost a launch widens;
* the threefry draws' time: :func:`frame_draws` makes the frame's draws
  alone (each sample's raygen jitter and lens disk, each bounce's lobe,
  fuzz and diffuse draws, the roulette's past ``RR_START``) and is timed
  the same way; its share is that time over the wrapper's.

Prints one JSON line (and appends it to ``--out``).  ``--count`` runs
:func:`count_operations` instead, on the CPU: no card needed.
"""

from __future__ import annotations

import argparse

import torch

from ..core import rng as srng
from ..integrator.path_trace import RR_START
from ..render import render_flat
from . import timing
from .mesh_frame import profile_call

SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
#: the profiler's name of kernel #3
INTERSECT = "spira::bvh_intersect"


def frame_draws(n, spp, max_depth, device, seed=0):
    """The threefry draws of one RGB frame of ``n`` rays a sample, without
    the rest of the estimator: the same keys, shapes and ``normal`` as
    ``render_flat``'s, so their time is the RNG's part of a frame."""
    base = srng.base_key(seed)
    for k in range(spp):
        skey = srng.fold_in(srng.sample_key(base, k), 0)
        srng.uniform(srng.bounce_key(skey, 0, srng.Stream.PIXEL_JITTER),
                     (n, 2), device)
        srng.uniform(srng.bounce_key(skey, 0, srng.Stream.LENS), (n, 2),
                     device)
        for b in range(max_depth):
            srng.uniform(srng.bounce_key(skey, b, srng.Stream.LOBE_SELECT),
                         (n, 3), device)
            srng.unit_vector(srng.bounce_key(skey, b,
                                             srng.Stream.METAL_FUZZ),
                             (n,), device)
            srng.uniform(srng.bounce_key(skey, b, srng.Stream.DIFFUSE_DIR),
                         (n, 2), device)
            if b > RR_START:
                srng.uniform(srng.bounce_key(skey, b, srng.Stream.ROULETTE),
                             (n,), device)


#: operations that launch no kernel on the card (views, allocations)
_NO_KERNEL = frozenset((
    "aten._local_scalar_dense", "aten._unsafe_view", "aten.alias",
    "aten.as_strided", "aten.detach", "aten.empty", "aten.expand",
    "aten.is_nonzero", "aten.lift_fresh", "aten.reshape", "aten.select",
    "aten.slice", "aten.split", "aten.squeeze", "aten.t", "aten.unbind",
    "aten.unsqueeze", "aten.view"))


def count_operations(spp=SHAPE["spp"], max_depth=SHAPE["max_depth"]):
    """The tensor operations of one RGB ``render_flat`` frame on a packed
    scene, counted on the CPU (the count does not depend on the frame's
    size): ``frame`` those of the estimator with #3 replaced by the card
    wrapper's own tensor operations (none: it allocates its four outputs,
    which the stub hands back as misses made outside the count, and the
    kernel's own launches are not counted), ``draws`` those of
    :func:`frame_draws`, each leaving out the operations that launch no
    kernel on the card."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from ..accel.pairs import attach_packed
    from ..kernels.bvh_megakernel import make_sorted_tile_intersect
    from ..render import accumulate_rows
    from ..scene.camera import make_camera
    from ..scene.scene import create_mesh_scene

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    def kernels(counter):
        return sum(v for k, v in counter.ops.items() if k not in _NO_KERNEL)

    width, height = 8, 4
    n = width * height
    miss = (torch.full((n,), 1e20), torch.zeros((n, 3)),
            torch.full((n,), -1, dtype=torch.int32),
            torch.full((n,), -1, dtype=torch.int32))

    def query(packed, o, d, active=None, with_slot=False):
        return miss if with_slot else miss[:3]

    scene = attach_packed(create_mesh_scene(subdivisions=1, device="cpu"))
    cam = make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                      device="cpu")
    with Count() as frame:
        accumulate_rows(
            scene, cam, srng.base_key(0), width=width, height=height,
            row_start=0, n_rows=height, sample_offset=0, n_samples=spp,
            max_depth=max_depth, semantics="physical",
            intersect_fn=make_sorted_tile_intersect(grad=True, query=query))
    with Count() as draws:
        frame_draws(n, spp, max_depth, "cpu")
    return dict(spp=spp, max_depth=max_depth, frame=kernels(frame),
                draws=kernels(draws))


def breakdown(scene, cam, shape=None, runs=5, seed=0):
    """The wavefront frame of ``scene`` on the card: see the module's
    docstring.  Returns a dict of the numbers."""
    shape = dict(SHAPE if shape is None else shape)
    n = shape["width"] * shape["height"]
    device = scene.device

    def frame():
        return render_flat(scene, cam, seed=seed, **shape)

    wrapper_ms = timing.cuda_ms(frame, runs)
    prof = profile_call(frame, runs=1)
    rng_ms = timing.cuda_ms(lambda: frame_draws(
        n, shape["spp"], shape["max_depth"], device, seed), runs)
    intersect_ms = prof["kernels_ms"].get(INTERSECT)
    intersect_launches = prof["launches"].get(INTERSECT)
    if not intersect_ms or not intersect_launches:
        raise RuntimeError(f"the profiled frame shows no launch of {INTERSECT}"
                           " (kernel #3): is the scene packed and on the "
                           "card?")
    device_ms = prof["device_ms"]
    return dict(
        shape=shape,
        wrapper_ms=wrapper_ms,
        profiled_wall_ms=prof["wall_ms"],
        device_ms=device_ms,
        idle_share=1.0 - device_ms / wrapper_ms,
        idle_share_profiled=1.0 - device_ms / prof["wall_ms"],
        intersect_ms=intersect_ms,
        intersect_launches=intersect_launches,
        intersect_ms_per_launch=intersect_ms / intersect_launches,
        intersect_share=intersect_ms / device_ms,
        device_ops=prof["device_ops"],
        runtime_calls=prof["runtime_calls"],
        top_kernels_ms=dict(list(prof["kernels_ms"].items())[:8]),
        rng_ms=rng_ms,
        rng_share=rng_ms / wrapper_ms,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also append the JSON line here")
    parser.add_argument("--count", action="store_true",
                        help="count a frame's tensor operations on the CPU")
    args = parser.parse_args(argv)
    if args.count:
        timing.record(args.out, **count_operations())
        return 0
    import spira_tpu_torch as sp

    device = timing.require_cuda("wavefront_frame")
    scene, _ = sp.create_bunny_scene(allow_download=False, device=device)
    cam = sp.bunny_camera(SHAPE["width"] / SHAPE["height"], device=device)
    timing.record(args.out, card=timing.card_line(),
                  device=torch.cuda.get_device_name(0),
                  **breakdown(scene, cam))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
