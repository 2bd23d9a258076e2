"""One rank of a world of ranks rendering the bunny sharded on the card:
the sharded engines, the sharded inverse step and ``cli render
--n-tile``, each timed and counted.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p LOCAL_RANK=0 \\
        python3 -m spira_tpu_torch.bench.sharded_world --job gloo2 \\
        --out FILE --work DIR

``--job gloo2`` (two ranks, both on ``cuda:0``: NCCL refuses two ranks on
one card, so the group is gloo's, asked for by name through
:func:`spira_tpu_torch.parallel.distributed.initialize`):

* ``render_flat_sharded`` of the bunny at 640x360, spp 16, depth 4 on
  ``cuda_bvh`` over a 2x1 mesh (the gathered frame equal to the unsharded
  kernel #2 frame to the bit) and a 1x2 mesh (within the float-sum bound
  ``SPLIT_ULPS``); on ``wavefront`` over 2x1 (#3's launches counted), and
  at 160x90 spp 2 its tile equal to the same shard body through #3's
  plain hook to the bit;
* one ``make_inverse_step(mesh=, intersect="packet")`` step at 160x90
  spp 4, the parameters then equal on both ranks to the bit;
* ``cli render --scene bunny --n-tile 2`` at 640x360 spp 16 depth 4, its
  PNG (rank 0's) equal to the tone-mapped gather of the same sharded
  render to the bit.

``--job nccl1`` (one rank, an NCCL group): an all-reduce of a tensor on
the card, and ``cli render --scene bunny --n-tile 1``, its PNG equal to
the tone-mapped unsharded wavefront frame.

Each sharded call is timed on the host's clock around the call and a
synchronisation of the card (the rank's wall time), with the kernels'
launch counts of the call, the bytes its collectives move from this rank
(the spp all-reduce, the gather, the gradient all-reduce) and, apart, the
time of the gather and of an all-reduce of the same bytes.  Writes one
JSON object to ``--out``; raises on any check that fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

#: the serving frame of the main paths
SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
#: the frame held against the plain hook (the plain walk syncs the host at
#: every step) and the inverse step's frame
SMALL = dict(width=160, height=90, spp=2, max_depth=4)
STEP = dict(width=160, height=90, spp=4, max_depth=4)
#: a split of the samples adds two partial sums of spp/2 samples: each
#: order is within (spp - 1) units of 2^-24 of the exact sum of the
#: channel's non-negative terms, so the two within twice that
SPLIT_ULPS = 2 * (SHAPE["spp"] - 1)


def _counters():
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import megakernel as mk

    return dict(bvh_megakernel=bk.render_flat_bvh_megakernel,
                bvh_mxu_megakernel=bk.render_flat_bvh_mxu_megakernel,
                bvh_intersect=bk.intersect_tile,
                plain_mesh_calls=bk.trace_mesh,
                plain_tracer_calls=mk.render_flat_fused)


def _reset():
    for name, fn in _counters().items():
        setattr(fn, "calls" if name.startswith("plain") else "launches", 0)


def _counts():
    return {name: getattr(fn, "calls" if name.startswith("plain")
                          else "launches")
            for name, fn in _counters().items()}


def _timed(fn):
    """(result, wall ms, launch counts) of ``fn()``, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    _reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), _counts()


def _digest(t):
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()[:16]


def _gather_ms(tile, mesh):
    """The gathered frame, and the gather's ms, timed from a barrier so
    that it leaves out the wait for the other ranks' renders."""
    from spira_tpu_torch.parallel import gather_image

    torch.cuda.synchronize()
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    flat = gather_image(tile, mesh)
    return flat, 1e3 * (time.perf_counter() - t0)


def _allreduce_ms(t, group, runs=5):
    """An all-reduce of ``t``'s bytes over ``group``: ms a call (median)."""
    buf = t.detach().clone()
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[1:]))


def _png(path):
    from spira_tpu_torch.io.image import load_png

    return load_png(path)


def _cli(argv):
    from spira_tpu_torch import cli

    t0 = time.perf_counter()
    _reset()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return 1e3 * (time.perf_counter() - t0), _counts()


def gloo2(device, work):
    import spira_tpu_torch as sp
    from spira_tpu_torch.core import rng as srng
    from spira_tpu_torch.diff.inverse import make_inverse_step
    from spira_tpu_torch.io import image as img_io
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels.megakernel import true_divide
    from spira_tpu_torch.parallel import (
        make_mesh,
        render_flat_sharded,
        replicate,
    )
    from spira_tpu_torch.render import accumulate_rows

    rank = dist.get_rank()
    rows = {}
    bunny, _ = sp.create_bunny_scene(allow_download=False, device=device)
    m21 = make_mesh(2, 1, device=device)
    m12 = make_mesh(1, 2, device=device)
    bunny = replicate(bunny, m21)
    cam = replicate(sp.bunny_camera(SHAPE["width"] / SHAPE["height"],
                                    device=device), m21)
    frame = bk.render_flat_bvh_megakernel(bunny, cam, **SHAPE).cpu().numpy()
    for label, mesh, engine in (("cuda_bvh 2x1", m21, "cuda_bvh"),
                                ("cuda_bvh 1x2", m12, "cuda_bvh"),
                                ("wavefront 2x1", m21, "wavefront")):
        call = lambda: render_flat_sharded(bunny, cam, mesh=mesh,  # noqa
                                           engine=engine, **SHAPE)
        call()  # warm-up
        tile, ms, got = _timed(call)
        flat, gather_ms = _gather_ms(tile, mesh)
        row = dict(mesh=list(mesh.shape.values()), engine=engine,
                   wall_ms=ms, launches=got, gather_ms=gather_ms,
                   gather_bytes_sent=tile.numel() * 4,
                   digest=_digest(flat))
        if mesh.n_spp > 1:
            row["allreduce_bytes"] = tile.numel() * 4
            row["allreduce_ms"] = _allreduce_ms(tile, mesh.spp_group)
        if engine == "cuda_bvh":
            diff = np.abs(flat - frame)
            row["max_abs_vs_unsharded"] = float(diff.max())
            row["bit_equal_unsharded"] = bool(np.array_equal(flat, frame))
            row["split_bound_ok"] = bool(
                (diff <= SPLIT_ULPS * 2.0 ** -24 * frame).all())
            want = dict(bvh_megakernel=1)
            if mesh.n_spp == 1 and not row["bit_equal_unsharded"]:
                raise AssertionError(f"{label}: differs from the "
                                     "unsharded #2 frame")
            if not row["split_bound_ok"]:
                raise AssertionError(f"{label}: past the float-sum bound, "
                                     f"max abs {diff.max()}")
        else:
            want = dict(bvh_intersect=SHAPE["spp"] * SHAPE["max_depth"])
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")
        rows[label] = row

    # the wavefront shard through #3 against the same shard body through
    # #3's plain hook, at a small frame
    small_cam = replicate(sp.bunny_camera(SMALL["width"] / SMALL["height"],
                                          device=device), m21)
    tile = render_flat_sharded(bunny, small_cam, mesh=m21,
                               engine="wavefront", **SMALL)
    n_rows = SMALL["height"] // 2
    plain = true_divide(accumulate_rows(
        bunny, small_cam, srng.base_key(0), width=SMALL["width"],
        height=SMALL["height"], row_start=rank * n_rows, n_rows=n_rows,
        sample_offset=0, n_samples=SMALL["spp"],
        max_depth=SMALL["max_depth"], semantics="physical",
        intersect_fn=bk.make_sorted_tile_intersect(
            query=bk.intersect_packed_plain)), float(SMALL["spp"]))
    same = torch.equal(tile, plain)
    rows["wavefront 2x1 plain hook"] = dict(bit_equal_plain_hook=same)
    if not same:
        raise AssertionError("the sharded wavefront through #3 differs "
                             "from the plain hook's")

    # one sharded inverse step through #3's slot form
    step_cam = replicate(sp.bunny_camera(STEP["width"] / STEP["height"],
                                         device=device), m21)
    target = sp.render_flat(bunny, step_cam, seed=1, **STEP)
    step, init = make_inverse_step(mesh=m21, intersect="packet", **STEP)
    params = {"albedo": torch.full_like(bunny.materials.albedo, 0.5),
              "emission": torch.ones_like(bunny.materials.emission)}
    opt = init(params)
    (params, opt, loss), ms, got = _timed(
        lambda: step(params, opt, bunny, step_cam, target, 0))
    mine = torch.cat([p.detach().reshape(-1) for p in params.values()])
    both = [torch.empty(mine.shape) for _ in range(2)]
    dist.all_gather(both, mine.cpu(), group=m21.group)
    same = torch.equal(both[0], both[1])
    rows["inverse step 2x1"] = dict(
        wall_ms=ms, launches=got, loss=float(loss), params_equal=same,
        grad_allreduce_bytes=mine.numel() * 4,
        grad_allreduce_ms=_allreduce_ms(mine, m21.group))
    # each sample is a checkpoint, replayed in the backward: two launches
    # a bounce
    want = dict(bvh_intersect=2 * STEP["spp"] * STEP["max_depth"])
    if not same or {k: v for k, v in got.items() if v} != want \
            or not np.isfinite(float(loss)):
        raise AssertionError(f"inverse step: params equal {same}, launches "
                             f"{got}, loss {float(loss)}")

    # cli render --n-tile 2: rank 0 writes the PNG
    png = os.path.join(work, "sharded_cli.png")
    argv = ["render", "--scene", "bunny", "--n-tile", "2", "--width",
            str(SHAPE["width"]), "--height", str(SHAPE["height"]), "--spp",
            str(SHAPE["spp"]), "--max-depth", str(SHAPE["max_depth"]),
            "--seed", "0", "--no-progress", "-o", png]
    ms, got = _cli(argv)
    tile = render_flat_sharded(bunny, cam, mesh=m21, **SHAPE)
    flat, _ = _gather_ms(tile, m21)
    want_img = img_io.to_uint8(img_io.tonemap_gamma(img_io.assemble_image(
        torch.from_numpy(flat), SHAPE["width"], SHAPE["height"])))
    dist.barrier(group=m21.group)
    same = bool(np.array_equal(_png(png), want_img))
    rows["cli render --n-tile 2"] = dict(wall_ms=ms, launches=got,
                                         png_equals_gather=same)
    want = dict(bvh_intersect=SHAPE["spp"] * SHAPE["max_depth"])
    if not same or {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"cli render --n-tile 2: PNG equal {same}, "
                             f"launches {got}")
    return rows


def nccl1(device, work):
    import spira_tpu_torch as sp
    from spira_tpu_torch.io import image as img_io

    x = torch.arange(4.0, device=device)
    dist.all_reduce(x)
    if not torch.equal(x.cpu(), torch.arange(4.0)):
        raise AssertionError(f"NCCL all-reduce of one rank gave {x}")
    png = os.path.join(work, "nccl_cli.png")
    argv = ["render", "--scene", "bunny", "--n-tile", "1", "--width",
            str(SHAPE["width"]), "--height", str(SHAPE["height"]), "--spp",
            str(SHAPE["spp"]), "--max-depth", str(SHAPE["max_depth"]),
            "--seed", "0", "--no-progress", "-o", png]
    ms, got = _cli(argv)
    bunny, _ = sp.create_bunny_scene(allow_download=False, device=device)
    cam = sp.bunny_camera(SHAPE["width"] / SHAPE["height"], device=device)
    want = img_io.to_uint8(img_io.tonemap_gamma(img_io.assemble_image(
        sp.render_flat(bunny, cam, grad_hook=False, **SHAPE),
        SHAPE["width"], SHAPE["height"])))
    same = bool(np.array_equal(_png(png), want))
    launches = {k: v for k, v in got.items() if v}
    if not same or launches != dict(
            bvh_intersect=SHAPE["spp"] * SHAPE["max_depth"]):
        raise AssertionError(f"cli render --n-tile 1 (NCCL): PNG equal "
                             f"{same}, launches {got}")
    return {"cli render --n-tile 1 (NCCL)": dict(
        wall_ms=ms, launches=got, png_equals_wavefront=same,
        backend=dist.get_backend())}


def main(argv=None) -> int:
    import datetime

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", choices=("gloo2", "nccl1"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--work", required=True, help="a directory for the "
                    "PNGs, the same for every rank")
    args = ap.parse_args(argv)
    from spira_tpu_torch.bench import timing
    from spira_tpu_torch.parallel.distributed import initialize

    device = timing.require_cuda("sharded_world")
    timeout = datetime.timedelta(seconds=120)
    if args.job == "gloo2":
        initialize(backend="gloo", device="cuda", timeout=timeout)
    else:  # a world of one rank, which initialize leaves alone
        dist.init_process_group(backend="nccl", init_method="env://",
                                timeout=timeout, device_id=device)
    try:
        rows = (gloo2 if args.job == "gloo2" else nccl1)(device, args.work)
        with open(args.out, "w") as f:
            json.dump(dict(rank=dist.get_rank(), job=args.job,
                           card=timing.card_line(), rows=rows), f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
