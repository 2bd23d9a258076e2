"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py [--save DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: requires CUDA, prints the card's name and power
   limit, the torch/CUDA versions, and builds the kernels from ``csrc/``
   (one nvcc per source, all started together), with each kernel's
   registers, stack and spills from ``ptxas -v``;
1b. the peak-rate probes (``spira_tpu_torch.bench``): kernel #9 in every
   mode and #10 in float32 and bfloat16 against their plain versions at
   the JAX shapes, on the JAX probes' inputs and on an input that varies
   by element; then the profilers' runs (``vpu_peak.time_modes``,
   ``packet_profile.tier_vpu``) at a grid that fills every SM, with launch
   counts, each launch's output held against its plain version on the
   same input; #9's rates give the special-function weights
   (``vpu_peak.sol_rates``) that price every bound below;
2. each kernel against its plain PyTorch version on the card, same tables
   and seed, with the tolerances stated beside each case: the sphere
   megakernel (``SPHERE_CASES``), the packed-BVH nearest-hit query on
   random and primary rays of the 72,960-triangle bunny, the packed-BVH
   path tracer (``BVH_CASES``), the spectral megakernel
   (``SPECTRAL_CASES``), the spectral packed-BVH path tracer
   (``SPECTRAL_BVH_CASES``), the adjoint kernel against autograd
   through the plain tracer (``GRAD_CASES``), with a central-difference
   check of its gradients, the streaming superleaf query on the bunny's
   random and primary rays, and the streaming superleaf path tracer and
   the superleaf-leaf BVH path tracer (``MXU_CASES``); the counting build
   of the packed-BVH path tracer on the bunny: its image bit-equal to the
   uncounted kernel's, its totals equal to the plain counting walk's, and
   pops == traversals + pushes;
3. the main paths, through the user's entry points, each with every launch
   count set to 0 just before and read just after: ``render`` of the bunny
   at 640x360, spp 16, depth 4 (engine ``cuda_bvh``), the same through
   ``render_bvh_with_counters`` (the counting build), ``intersect_tile``
   on the bunny's primary rays, ``render`` of the sphere demo scene at the
   same shape (engine ``cuda``), and ``render(..., spectral=True)`` of the
   Cornell box (engine ``cuda``, the spectral megakernel) and of the bunny
   (engine ``cuda_spectral_bvh``) at the same shape; each image is checked
   against the plain version's render, and the spectral Cornell box
   against the RGB one; then the differentiable step of ``bench.py``
   (``render_flat_hybrid_grad``, MSE, ``backward``) on the sphere demo at
   exact replay and at ``grad_spp=4``, a few gradient-descent updates of
   the albedo, each step one forward and one adjoint launch and no plain
   tracer call; and the superleaf engines: ``render`` of the bunny on
   ``cuda_bvh_mxu`` and of the 1,600-triangle mesh scene on ``cuda_mxu``
   at 640x360, spp 16, depth 4, each one launch and no plain call, each
   image held against its plain version and against ``cuda_bvh``'s image
   of the same scene and seed, and ``intersect_tile_mxu`` on the bunny's
   primary rays, held against the packed-BVH query;
4. timing with CUDA events (one warm-up, median of 10, of
   ``PLAIN_REPEATS`` for the plain versions), and a
   torch.profiler breakdown of the main-path wrappers' time on the card;
   each kernel's bound from the work this run's inputs need (counted
   with the plain versions, #2's by its counting build and held against
   the plain count), priced by ``utils/sol.py``: the largest of the ALU
   instructions at the card's issue rate (128 lanes a clock an SM at the
   max SM clock), the special-function calls times the weights phase 1b
   measured at the same rate, and the bytes over the memory rate, with
   the data-sheet bound (every operation over 67 TFLOP/s) beside it; the
   probes' bound is their counted operations at the issue rate; each
   kernel's share of its bound and launches x (time - bound), largest
   first; the superleaf kernels beside ``cuda_bvh`` on the same calls;
   the counting build's time beside the uncounted one.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  ``--save DIR`` also writes the main
paths' PNGs there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: the plain versions, seconds a call, are reference only: timed this
#: many times (the kernels bench.timing.REPEATS times)
PLAIN_REPEATS = 2
MAIN = dict(width=640, height=360, spp=16, max_depth=4)
#: the peak-rate probes' comparisons: the separate
#: multiply-add and kernel #10 bit-equal; the contracted step (plain
#: version: the float64 sum rounded once, so a double rounding may move a
#: last bit) within PEAK_FMA_ULP units in the last place of the chains'
#: sums; the special-function chains (torch's calls on the card against
#: nvcc's, the same precise library functions) within PEAK_SPECIAL_RTOL
PEAK_FMA_ULP, PEAK_SPECIAL_RTOL = 4, 1e-6
#: the shape the kernel table of PERF.md times the BVH kernel and its
#: plain version at
BVH_TIMED = dict(width=640, height=360, spp=4, max_depth=4)
#: sphere megakernel cases: (name, scene function, camera function, shape,
#: tolerances).  Depth 1 sees only primary hits and raygen jitter; deeper
#: paths may take another branch where a transcendental differs in its
#: last bit, which moves a whole path.
SPHERE_CASES = (
    ("a: demo 640x360 spp1 d1", "create_scene", "default_camera",
     dict(width=640, height=360, spp=1, max_depth=1),
     dict(atol=1e-5, frac=0.999, mean_rel=0.005)),
    ("b: demo 640x360 spp16 d4", "create_scene", "default_camera",
     MAIN, dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
    ("c: cornell 256x256 spp16 d6", "create_cornell_box", "cornell_camera",
     dict(width=256, height=256, spp=16, max_depth=6),
     dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
)
#: packed-BVH path tracer cases: (name, scene key, shape).  At least 99% of
#: pixel-channels within 1e-4 and channel means within 0.5%.
BVH_TOL = dict(atol=1e-4, frac=0.99, mean_rel=0.005)
BVH_CASES = (
    ("d: bunny 640x360 spp1 d2", "bunny",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("e: bunny 640x360 spp4 d4", "bunny", BVH_TIMED),
    ("f: mesh 256x256 spp4 d4", "mesh",
     dict(width=256, height=256, spp=4, max_depth=4)),
)
#: nearest-hit query limits: miss sets equal but for this share of rays;
#: t on common hits to this relative tolerance; material id equal on this
#: share; normal within NORMAL_ATOL on this share.
MISS_SHARE, T_RTOL, MID_SHARE = 1e-4, 1e-5, 0.9999
NORMAL_ATOL, NORMAL_SHARE = 1e-5, 0.999
N_RANDOM_RAYS = 1 << 16
#: spectral megakernel cases: (name, scene key, shape, tolerances), limits
#: as for the sphere megakernel.  The Cornell box's flint glass disperses
#: (the hero collapse), and depth 6 runs Russian roulette.
SPECTRAL_CASES = (
    ("g: demo 640x360 spp1 d1", "demo",
     dict(width=640, height=360, spp=1, max_depth=1),
     dict(atol=1e-5, frac=0.999, mean_rel=0.005)),
    ("h: cornell 256x256 spp16 d6", "cornell_sq",
     dict(width=256, height=256, spp=16, max_depth=6), BVH_TOL),
    ("i: cornell 640x360 spp16 d4", "cornell", MAIN, BVH_TOL),
)
#: spectral packed-BVH cases: (name, scene key, shape), limits BVH_TOL
SPECTRAL_BVH_CASES = (
    ("j: bunny 640x360 spp1 d2", "bunny",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("k: bunny 640x360 spp4 d4", "bunny", BVH_TIMED),
    ("l: dispersive icosphere 256x256 spp4 d6", "dispersive",
     dict(width=256, height=256, spp=4, max_depth=6)),
)
#: adjoint-kernel cases: (name, scene key, shape, grad_spp, loss mode).
#: VJP mode takes a seeded random cotangent; loss mode a target rendered
#: by the plain tracer at seed 99.  Limits: loss within GRAD_LOSS_RTOL
#: relative, each table's gradient within GRAD_REL_L2 of the plain
#: autograd backward's, in relative L2 norm (float atomics sum in a
#: different order, and paths near silhouettes amplify the last bits).
GRAD_CASES = (
    ("m: demo 128x64 spp4 d4 vjp", "demo",
     dict(width=128, height=64, spp=4, max_depth=4), 4, False),
    ("n: demo 640x360 spp16 d4 grad_spp4 vjp", "demo", MAIN, 4, False),
    ("o: thin-lens demo 256x128 spp4 d3 vjp", "lens",
     dict(width=256, height=128, spp=4, max_depth=3), 4, False),
    ("p: cornell 256x256 spp4 d6 vjp", "cornell_sq",
     dict(width=256, height=256, spp=4, max_depth=6), 4, False),
    ("q: demo 640x360 spp16 d4 loss", "demo", MAIN, 16, True),
)
GRAD_LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-3
#: superleaf path tracer cases, limits BVH_TOL: (name, engine, scene key,
#: shape); "mxu" is the streaming kernel #7, "bvh_mxu" the packed-BVH walk
#: with superleaf leaves #2b
MXU_CASES = (
    ("r: #7 mesh 256x256 spp4 d4", "mxu", "mesh_mxu",
     dict(width=256, height=256, spp=4, max_depth=4)),
    ("s: #7 mesh 640x360 spp1 d2", "mxu", "mesh_mxu_wide",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("t: #2b bunny 640x360 spp1 d2", "bvh_mxu", "bunny_sl",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("u: #2b bunny 640x360 spp4 d4", "bvh_mxu", "bunny_sl", BVH_TIMED),
    ("v: #2b mesh 256x256 spp4 d4", "bvh_mxu", "mesh_sl",
     dict(width=256, height=256, spp=4, max_depth=4)),
)
#: the differentiable step: albedo of the red sphere and the ground
#: perturbed as in tests/test_grad.py, plain gradient descent
STEP_ALBEDO = ((0.2, 0.7, 0.7), (0.9, 0.2, 0.9))
STEP_LR, STEP_SEEDS = 2.0, range(5)


def log(*args):
    print(*args, flush=True)


def device_breakdown(fn, runs=5):
    """Kernel time on the card by name over ``runs`` calls of ``fn``
    (torch.profiler), and the card's idle share of the host's window."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # "void at::native::foo_kernel<...>(...)" -> "at::native::foo_kernel"
            name = re.split(r"[<(]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    return dict(
        runs=runs,
        wall_ms_per_call=wall_us / runs / 1e3,
        device_ms_per_call=busy_us / runs / 1e3,
        idle_share=1.0 - busy_us / wall_us if by_name else None,
        kernels_ms_per_call={k: v / runs / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])},
    )


def log_breakdown(card, what, breakdown):
    if breakdown["idle_share"] is None:
        log(f"[profile] {what}: no device time in the trace: not measured")
        return
    top = list(breakdown["kernels_ms_per_call"].items())[:4]
    log(f"[profile] {card}: {what} wrapper "
        f"{breakdown['wall_ms_per_call']:.4f} ms/call on the host, "
        f"{breakdown['device_ms_per_call']:.4f} ms/call on the card, "
        f"idle share {breakdown['idle_share']:.4f}; top kernels "
        f"(ms/call): {[(k, round(v, 5)) for k, v in top]}")


def check_images(name, kernel, plain, tol):
    """Hold a kernel's flat HDR buffer against the plain version's."""
    if kernel.shape != plain.shape or not torch.isfinite(kernel).all():
        raise AssertionError(f"{name}: kernel output bad shape or not finite")
    diff = (kernel - plain).abs()
    max_abs = float(diff.max())
    frac_off = float((diff > tol["atol"]).float().mean())
    km, pm = kernel.mean(0).tolist(), plain.mean(0).tolist()
    rel = max(abs(a / b - 1.0) for a, b in zip(km, pm))
    log(f"[compare] {name}: max_abs {max_abs:.3e}, "
        f"share > {tol['atol']:g}: {frac_off:.6f} "
        f"(limit {1 - tol['frac']:.4f}), channel means kernel "
        f"{[round(x, 6) for x in km]} plain {[round(x, 6) for x in pm]}, "
        f"max rel {rel:.2e} (limit {tol['mean_rel']})")
    if frac_off > 1.0 - tol["frac"] or rel > tol["mean_rel"]:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return dict(case=name, max_abs_err=max_abs, share_over_atol=frac_off,
                mean_rel=rel)


def compare_sphere(sp, mk, name, scene_fn, cam_fn, shape, tol, device):
    scene = getattr(sp, scene_fn)(device=device)
    w, h = shape["width"], shape["height"]
    cam = getattr(sp, cam_fn)(w / h, device=device)
    kernel = mk.render_flat_megakernel(scene, cam, seed=7, **shape)
    plain = mk.render_flat_fused(scene, cam, seed=7, **shape)
    torch.cuda.synchronize()
    return check_images(name, kernel, plain, tol)


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


def random_rays(n, device, seed=0):
    """Origins in a box around the bunny; half the directions aimed at it,
    half uniform on the sphere."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-1.2, 0.0, -1.2])
    hi = torch.tensor([1.2, 1.4, 1.2])
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    d = torch.randn(n, 3, generator=g)
    d[::2] = torch.tensor([0.0, 0.45, 0.0]) - o[::2] + 0.3 * d[::2]
    d = d / d.norm(dim=1, keepdim=True)
    return o.to(device), d.to(device)


def compare_intersect(name, kernel_fn, plain_fn, o, d):
    """A nearest-hit kernel ``kernel_fn(o, d)`` against ``plain_fn(o, d)``
    (its plain version, or another query) under the query limits."""
    kt, kn, kmid = kernel_fn(o, d)
    pt, pn, pmid = plain_fn(o, d)
    torch.cuda.synchronize()
    n = o.shape[0]
    kmiss, pmiss = kt >= 1e19, pt >= 1e19
    miss_share = float((kmiss != pmiss).float().mean())
    both = ~kmiss & ~pmiss
    t_err = (kt[both] - pt[both]).abs()
    t_rel = float((t_err / pt[both].abs()).max()) if both.any() else 0.0
    mid_share = float((kmid == pmid).float().mean())
    n_share = float(((kn - pn).abs().amax(dim=1) <= NORMAL_ATOL)
                    .float().mean())
    log(f"[compare] {name}: {n} rays, {int(both.sum())} common hits, miss "
        f"sets differ on {miss_share:.2e} (limit {MISS_SHARE:g}), t max rel "
        f"{t_rel:.2e} (limit {T_RTOL:g}), mat id equal on {mid_share:.6f} "
        f"(limit {MID_SHARE}), normal within {NORMAL_ATOL:g} on "
        f"{n_share:.6f} (limit {NORMAL_SHARE})")
    if not torch.isfinite(kt).all() or kn.shape != (n, 3):
        raise AssertionError(f"{name}: kernel output bad shape or not finite")
    if (miss_share > MISS_SHARE or t_rel > T_RTOL or mid_share < MID_SHARE
            or n_share < NORMAL_SHARE):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return dict(case=name, rays=n, common_hits=int(both.sum()),
                max_abs_err=float(t_err.max()) if both.any() else 0.0,
                t_max_rel=t_rel, miss_share=miss_share, mid_share=mid_share,
                normal_share=n_share)


def counters():
    """Every kernel wrapper with a launch count, by kernel name."""
    from spira_tpu_torch.bench import packet_profile, vpu_peak
    from spira_tpu_torch.kernels import (
        bvh_megakernel,
        grad_megakernel,
        megakernel,
        mxu_megakernel,
        spectral_bvh,
        spectral_fused,
    )

    return dict(
        megakernel=megakernel.render_flat_megakernel,
        bvh_megakernel=bvh_megakernel.render_flat_bvh_megakernel,
        bvh_counted=bvh_megakernel.render_bvh_with_counters,
        vpu_peak=vpu_peak.vpu_peak,
        vpu_dtype=packet_profile.vpu_dtype,
        bvh_intersect=bvh_megakernel.intersect_tile,
        spectral_megakernel=spectral_fused.render_flat_spectral_megakernel,
        spectral_bvh_megakernel=(
            spectral_bvh.render_flat_spectral_bvh_megakernel),
        grad_megakernel=grad_megakernel.render_grad_megakernel,
        mxu_megakernel=mxu_megakernel.render_flat_mxu_megakernel,
        mxu_intersect=mxu_megakernel.intersect_tile_mxu,
        bvh_mxu_megakernel=bvh_megakernel.render_flat_bvh_mxu_megakernel,
    )


def reset_counts():
    from spira_tpu_torch.kernels import bvh_megakernel, megakernel

    for fn in counters().values():
        fn.launches = 0
    megakernel.render_flat_fused.calls = 0
    bvh_megakernel.trace_mesh.calls = 0


def counts():
    from spira_tpu_torch.kernels import bvh_megakernel, megakernel

    got = {name: fn.launches for name, fn in counters().items()}
    got["plain_tracer_calls"] = megakernel.render_flat_fused.calls
    got["plain_mesh_calls"] = bvh_megakernel.trace_mesh.calls
    return got


def count_work(module, factory, fn, stream_blocks=0):
    """Run ``fn()`` (a plain version) with ``module.factory``'s intersector
    counting the live path segments it is asked for and the hits among
    them, and the packed walk counting its pops, leaf triangles and
    superleaf blocks: the work a kernel does on the same inputs (the plain
    walk pops the records the kernel's walk pops, in the same order).
    ``stream_blocks``: the superleaf blocks every segment tests, for the
    streaming kernels, which have no walk."""
    from spira_tpu_torch.kernels import bvh_megakernel as bk

    made = getattr(module, factory) if factory else None
    slab, leaf_hits, block_hits = bk._slab, bk._leaf_hits, bk._block_hits
    work = dict(segments=0, hits=0, pops=0, leaf_tris=0, blocks=0)

    def counting_slab(rec, half, *args):
        if half == 0:
            work["pops"] += rec.shape[0]
        return slab(rec, half, *args)

    def counting_leaf_hits(slots, form, max_leaf, ptr, cnt, *args):
        work["leaf_tris"] += int(cnt.sum())
        return leaf_hits(slots, form, max_leaf, ptr, cnt, *args)

    def counting_block_hits(views, ptr, *args):
        work["blocks"] += ptr.numel()
        return block_hits(views, ptr, *args)

    def counting(*args, **kwargs):
        intersect = made(*args, **kwargs)

        def wrapped(o3, d3, active=None):
            out = intersect(o3, d3, active)
            live = (torch.ones_like(out[0]) if active is None
                    else active.clone())
            work["segments"] += int(live.sum())
            work["hits"] += int((live & out[0]).sum())
            work["blocks"] += int(live.sum()) * stream_blocks
            return out

        return wrapped

    if factory:
        setattr(module, factory, counting)
    bk._slab, bk._leaf_hits = counting_slab, counting_leaf_hits
    bk._block_hits = counting_block_hits
    try:
        with torch.no_grad():
            fn()
    finally:
        if factory:
            setattr(module, factory, made)
        bk._slab, bk._leaf_hits = slab, leaf_hits
        bk._block_hits = block_hits
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return work


def price(work, rates):
    """A kernel's bound for ``work`` (operations by ``sol.CLASSES`` and
    ``bytes``), priced by ``sol.lower_bound_seconds`` at ``rates``:
    bound_ms, bound_by ("bytes" or "operations"), the term that bounds it
    (alu, special or bytes), every term in ms, and the data-sheet bound
    beside it for the record."""
    from spira_tpu_torch.utils import sol

    b = sol.lower_bound_seconds(work, rates)
    return dict(bound_ms=b["bound_s"] * 1e3,
                bound_by="bytes" if b["bound_by"] == "bytes" else "operations",
                bound_term=b["bound_by"],
                bound_terms_ms={k: v * 1e3 for k, v in b["terms"].items()},
                datasheet_bound_ms=sol.datasheet_bound_seconds(work) * 1e3,
                ops=work)


def sol_bound(units, nbytes, rates):
    """:func:`price` of ``units`` of work (``sol.OPS`` names) and
    ``nbytes`` bytes."""
    from spira_tpu_torch.utils import sol

    return price(dict(sol.ops_of(units), bytes=nbytes), rates)


def table_bytes(*tensors):
    return sum(4 * t.numel() for t in tensors)


def coeff_bytes(tables):
    """Bytes of a superleaf packing's coefficient tables."""
    return table_bytes(tables.coeff_uv, tables.coeff_t, tables.coeff_pay)


def rel_l2(kernel, plain):
    den = float(torch.linalg.norm(plain))
    num = float(torch.linalg.norm(kernel - plain))
    return num / den if den > 0 else num


def compare_grad(gk, mk, name, scene, cam, shape, grad_spp, loss_mode):
    """The adjoint kernel against autograd through the plain tracer, same
    tables, seed and cotangent (or target)."""
    w, h = shape["width"], shape["height"]
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    if loss_mode:
        pix = mk.render_flat_fused(scene, cam, seed=99, **shape)
    else:
        g = torch.Generator().manual_seed(5)
        pix = (torch.rand(w * h, 3, generator=g) - 0.5).to(cam.origin.device)
    kw = dict(loss_mode=loss_mode, grad_spp=grad_spp, seed=7, **shape)
    loss_k, *grads_k = gk.render_grad_megakernel(scene, cam, tables, pix,
                                                 **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss_p, *grads_p = gk.grad_tables_plain(scene, cam, tables, pix, **kw)
    end.record()
    torch.cuda.synchronize()
    out = dict(case=name, plain_ms_once=start.elapsed_time(end))
    msg = f"[compare] {name}:"
    ok = True
    if loss_mode:
        loss_rel = abs(float(loss_k) / float(loss_p) - 1.0)
        out.update(loss=float(loss_k), loss_plain=float(loss_p),
                   loss_rel=loss_rel)
        msg += (f" loss {float(loss_k):.8g} plain {float(loss_p):.8g} rel "
                f"{loss_rel:.2e} (limit {GRAD_LOSS_RTOL:g});")
        ok &= loss_rel <= GRAD_LOSS_RTOL
    max_abs = 0.0
    for table, k, p in zip(("camera", "sphere", "triangle"), grads_k,
                           grads_p):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{name}: {table} gradient not finite")
        rel = rel_l2(k, p)
        max_abs = max(max_abs, float((k - p).abs().max()) if k.numel()
                      else 0.0)
        out[f"{table}_rel_l2"] = rel
        msg += (f" {table} rel L2 {rel:.2e} (|plain| "
                f"{float(torch.linalg.norm(p)):.4g}; limit {GRAD_REL_L2:g})")
        ok &= rel <= GRAD_REL_L2
    out["max_abs_err"] = max_abs
    log(msg)
    if not ok:
        raise AssertionError(f"{name}: adjoint kernel disagrees with the "
                             f"plain autograd backward")
    return out


def with_materials(scene, **fields):
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, **fields))


def check_finite_differences(sp, scene, cam, shape):
    """Central differences of the forward kernel (float32, eps 2e-3) on 3
    albedo and 3 emission entries against the adjoint kernel's gradient
    of the same MSE, under tests/test_grad.py's rule
    |fd - an| <= max(2e-3, 0.06 |fd|)."""
    from spira_tpu_torch.kernels import megakernel as mk

    target = torch.full((shape["width"] * shape["height"], 3), 0.25,
                        device=cam.origin.device)
    albedo = scene.materials.albedo.clone().requires_grad_()
    emission = scene.materials.emission.clone().requires_grad_()
    img = sp.render_flat_hybrid_grad(
        with_materials(scene, albedo=albedo, emission=emission), cam,
        seed=3, **shape)
    ((img - target) ** 2).mean().backward()

    def loss(**fields):
        img = mk.render_flat_megakernel(with_materials(scene, **fields), cam,
                                        seed=3, **shape)
        return float(((img - target) ** 2).mean())

    rs = np.random.default_rng(0)
    eps, checks = 2e-3, []
    for name, grad in (("albedo", albedo.grad), ("emission", emission.grad)):
        base = getattr(scene.materials, name)
        for _ in range(3):
            i, j = int(rs.integers(base.shape[0])), int(rs.integers(3))
            probes = []
            for sign in (1.0, -1.0):
                p = base.clone()
                p[i, j] += sign * eps
                probes.append(loss(**{name: p}))
            fd = (probes[0] - probes[1]) / (2 * eps)
            an = float(grad[i, j])
            limit = max(2e-3, 0.06 * abs(fd))
            log(f"[fd] {name}[{i},{j}]: central difference {fd:.6f}, "
                f"adjoint {an:.6f}, |gap| {abs(fd - an):.2e} (limit "
                f"{limit:.2e})")
            if abs(fd - an) > limit:
                raise AssertionError(f"{name}[{i},{j}]: gradient disagrees "
                                     f"with central differences")
            checks.append(dict(entry=f"{name}[{i},{j}]", fd=fd, adjoint=an))
    return checks


def dispersive_mesh(sp, device):
    """A packed scene with a dispersive sphere in view: a 20-triangle
    icosphere over a ground sphere, a light, and flint-like glass
    (cauchy_b 0.01) on the specular lobe."""
    from spira_tpu_torch.accel.bvh import build_bvh_for_triangles
    from spira_tpu_torch.scene.obj import icosphere

    mesh = icosphere(center=(0.0, 0.3, 0.0), radius=0.6, subdivisions=0,
                     material=0)
    materials = sp.make_materials([
        dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
        dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
        dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0, ior=1.5,
             transmission=1.0, cauchy_b=0.01),
    ], device="cpu")
    spheres = sp.make_spheres([((0.0, -100.5, 0.0), 100.0, 1),
                               ((0.0, 5.0, 0.0), 1.0, 2),
                               ((0.9, 0.0, 0.6), 0.35, 3)], device="cpu")
    scene = sp.make_scene(spheres=spheres, triangles=mesh,
                          materials=materials,
                          bvh=build_bvh_for_triangles(mesh))
    return sp.attach_packed(scene).to(device)


def check_main(what, kernel, img, plain_img, got, png):
    """A main path's image: ``kernel`` launched, the image not empty, and
    its uint8 mean within one level of the plain version's at the same
    spp (a noisier image sits lower after the concave tone map)."""
    gap = abs(float(img.mean()) - float(plain_img.mean()))
    log(f"[main] {what}: image {img.shape} {img.dtype}, mean "
        f"{img.mean():.4f} (plain {plain_img.mean():.4f}), std "
        f"{img.std():.4f}, png {os.path.getsize(png)} bytes, launches {got}")
    if got[kernel] < 1:
        raise AssertionError(f"{what} did not launch {kernel}")
    if img.ndim != 3 or img.shape[2] != 3 or img.std() == 0:
        raise AssertionError(f"{what}: image is empty or constant")
    if gap > 1.0:
        raise AssertionError(f"{what}: uint8 means differ by {gap} > 1")


def check_peak(vp, x, outs, where):
    """Kernel #9's outputs ``{mode: output}`` on ``x`` against its plain
    version on the same input: separate bit-equal, contracted within
    PEAK_FMA_ULP, the special functions within PEAK_SPECIAL_RTOL."""
    checks = []
    for mode, k in outs.items():
        p = vp.peak_plain(x, mode)
        torch.cuda.synchronize()
        if k.shape != p.shape or not torch.isfinite(k).all():
            raise AssertionError(f"#9 {mode} {where}: bad shape or not "
                                 f"finite")
        diff = (k - p).abs()
        rel = float((diff / p.abs().clamp(min=1e-30)).max())
        same = torch.equal(k, p)
        if mode == "separate":
            ok, limit = same, "bit-equal"
        elif mode == "contracted":
            # the chains' sums are positive: float32 bit patterns order them
            ulp = int((k.view(torch.int32) - p.view(torch.int32)).abs().max())
            ok, limit = ulp <= PEAK_FMA_ULP, f"{PEAK_FMA_ULP} ulp (got {ulp})"
        else:
            ok, limit = rel <= PEAK_SPECIAL_RTOL, f"rel {PEAK_SPECIAL_RTOL:g}"
        log(f"[compare] #9 {mode} {where}: max abs {float(diff.max()):.3e}, "
            f"max rel {rel:.3e}, bit-equal {same} (limit {limit})")
        if not ok:
            raise AssertionError(f"#9 {mode} {where}: kernel disagrees with "
                                 f"plain")
        checks.append(dict(case=f"#9 {mode} {where}",
                           max_abs_err=float(diff.max()), max_rel_err=rel,
                           bit_equal=same))
    return checks


def check_dtype(pp, x, outs, where):
    """Kernel #10's outputs ``{dtype: output}`` on ``x`` against its plain
    version on the same input: bit-equal (one rounding to the type per
    operation on both sides)."""
    checks = []
    for dtype, k in outs.items():
        p = pp.vpu_dtype_plain(x, dtype)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        max_abs = float((k - p).abs().max())
        log(f"[compare] #10 {dtype} {where}: max abs {max_abs:.3e}, "
            f"bit-equal {same} (limit bit-equal); first value "
            f"{float(k[0]):.8g}")
        if not same or not torch.isfinite(k).all():
            raise AssertionError(f"#10 {dtype} {where}: kernel disagrees "
                                 f"with plain")
        checks.append(dict(case=f"#10 {dtype} {where}", max_abs_err=max_abs,
                           bit_equal=same))
    return checks


def check_probes_jax_shapes(vp, pp, device):
    """Both probes at the JAX shapes, on the JAX probes' inputs (#9: a
    (32, 128) tile of ones; #10: a (256, 128) tile of 0.5) and on an input
    that varies by element."""
    n9, n10 = int(np.prod(vp.JAX_SHAPE)), pp.ROWS * pp.COLS
    checks = []
    for what, x in (("ones", torch.ones(n9, device=device)),
                    ("varied", vp.probe_input(n9, device, seed=1))):
        checks += check_peak(vp, x, {m: vp.vpu_peak(x, m) for m in vp.MODES},
                             f"{vp.JAX_SHAPE} {what}")
    for what, x in (("0.5", torch.full((n10,), 0.5, device=device)),
                    ("varied", vp.probe_input(n10, device, seed=1))):
        checks += check_dtype(pp, x, {d: pp.vpu_dtype(x, d)
                                      for d in pp.DTYPES},
                              f"({pp.ROWS}, {pp.COLS}) {what}")
    return checks


def check_counted(bk, scene, cam):
    """The counting build of #2 on ``scene``: its image bit-equal to the
    uncounted kernel's at MAIN, its totals at BVH_TIMED equal to the plain
    counting walk's, its image there held against the plain version's,
    and pops == traversals + pushes."""
    img, ctr = bk.render_bvh_with_counters(scene, cam, **MAIN)
    ref = bk.render_flat_bvh_megakernel(scene, cam, **MAIN)
    torch.cuda.synchronize()
    same = torch.equal(img, ref)
    log(f"[compare] #2 counting build 640x360 spp16 d4 against the "
        f"uncounted kernel: bit-equal {same}; counters {ctr}")
    if not same:
        raise AssertionError("#2: the counting build's image differs")
    img4, ctr4 = bk.render_bvh_with_counters(scene, cam, **BVH_TIMED)
    plain_img, plain_counts = bk.render_bvh_counters_fused(scene, cam,
                                                           **BVH_TIMED)
    torch.cuda.synchronize()
    plain = {k: int(v.sum()) for k, v in plain_counts.items()}
    log(f"[compare] #2 counting build 640x360 spp4 d4: kernel {ctr4}, plain "
        f"walk {plain}")
    if ctr4 != plain:
        raise AssertionError("#2: the counting kernel's totals differ from "
                             "the plain walk's")
    for c in (ctr, ctr4):
        if c["pops"] != c["traversals"] + c["pushes"]:
            raise AssertionError(f"#2: pops != traversals + pushes in {c}")
    check = check_images("#2 counting build 640x360 spp4 d4", img4,
                         plain_img, BVH_TOL)
    return dict(counters_640x360_spp16_d4=ctr, counters_640x360_spp4_d4=ctr4,
                image_bit_equal_uncounted=same, **check)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save", help="also write the main paths' PNGs "
                        "into this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1

    # ---- 1. card and toolchain
    import spira_tpu_torch as sp
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import packet_profile as pp
    from spira_tpu_torch.bench import timing
    from spira_tpu_torch.bench.timing import card_line
    from spira_tpu_torch.bench.timing import cuda_ms as time_ms
    from spira_tpu_torch.bench import vpu_peak as vp
    from spira_tpu_torch.io import image as img_io
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import grad_megakernel as gk
    from spira_tpu_torch.kernels import megakernel as mk
    from spira_tpu_torch.kernels import mxu_megakernel as xk
    from spira_tpu_torch.kernels import spectral_bvh as sb
    from spira_tpu_torch.kernels import spectral_fused as sf
    from spira_tpu_torch.utils import sol

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    names = ("megakernel", "bvh_megakernel", "spectral_megakernel",
             "grad_megakernel", "mxu_megakernel", "peak")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.load, names)))
    ptxas = {}
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.build_seconds:.1f} s "
            f"({'built' if lib.build_seconds else 'cached'}) -> "
            f"{lib.path.name}")
        # ptxas -v: "Compiling entry function '<mangled>'", then the
        # stack/spill and register lines of that kernel
        kernel = None
        for line in lib.log.splitlines():
            found = re.search(r"entry function '_ZN5spira(\d+)(\w+)", line)
            if found:
                kernel = found.group(2)[:int(found.group(1))]
            elif kernel and ("spill" in line or "registers" in line):
                ptxas.setdefault(kernel, []).append(line.strip())
    for kernel, lines in ptxas.items():
        log(f"[ptxas] {kernel}: {' | '.join(lines)}")

    # ---- 1b. the peak-rate probes (#9, #10): each against its plain
    # version at the JAX shape, then the profilers' runs at a grid that
    # fills every SM, each output held against the plain version; #9's
    # rates give the special-function weights of every bound below
    launches = {}
    probe_checks = check_probes_jax_shapes(vp, pp, device)
    probe = dict(n_peak=vp.fill_elements(device),
                 n_dtype=vp.fill_elements(device, pp.WAVES))
    x_peak = vp.probe_input(probe["n_peak"], device)
    reset_counts()
    peak_ms, peak_out = vp.time_modes(x_peak)
    dtype_rows, dtype_out = pp.tier_vpu(device, card=card)
    torch.cuda.synchronize()
    got = counts()
    for kernel in ("vpu_peak", "vpu_dtype"):
        launches[kernel] = got[kernel]
        if got[kernel] < 11:
            raise AssertionError(f"the probes launched {kernel} "
                                 f"{got[kernel]} times")
    if sum(got.values()) != got["vpu_peak"] + got["vpu_dtype"]:
        raise AssertionError(f"the probes launched {got}")
    # the timed launches' outputs, against the plain versions on the same
    # inputs (tier_vpu steps vpu_peak.probe_input of each grid's size)
    probe_checks += check_peak(vp, x_peak, peak_out,
                               f"fill grid {probe['n_peak']} varied")
    for grid, n in (("jax", pp.ROWS * pp.COLS), ("fill", probe["n_dtype"])):
        probe_checks += check_dtype(
            pp, vp.probe_input(n, device),
            {d: dtype_out[grid, d] for d in pp.DTYPES},
            f"{grid} grid {n} varied")
    peak_checks = [c for c in probe_checks if c["case"].startswith("#9")]
    dtype_checks = [c for c in probe_checks if c["case"].startswith("#10")]
    peak_rates = vp.rates_from_ms(peak_ms, probe["n_peak"])
    issue_rate = sol.issue_rate_per_s(
        torch.cuda.get_device_properties(0).multi_processor_count,
        timing.max_sm_clock_hz())
    rates = vp.sol_rates(peak_rates, issue_rate, f"{card}, this run")
    dtype_ms = {(r["grid"], r["dtype"]): r["ms"] for r in dtype_rows}
    for mode in vp.MODES:
        log(f"[probe] {card}: #9 {mode}, {probe['n_peak']} elements: "
            f"{peak_ms[mode]:.4f} ms, {peak_rates[mode]:.5g} "
            f"{'lane-ops' if mode in vp.INSTRUCTIONS else 'calls'}/s")
    for r in dtype_rows:
        log(f"[probe] {card}: #10 {r['dtype']} {r['grid']} grid, "
            f"{r['elements']} elements: {r['ms']:.4f} ms, "
            f"{r['gflop_s']:.6g} GFLOP/s")
    achieved = peak_rates["separate"]  # 3 lane-ops, 3 instructions a step
    contracted = (peak_rates["contracted"] * vp.INSTRUCTIONS["contracted"]
                  / vp.LANE_OPS)
    log(f"[probe] {card}: issue rate {issue_rate:.5g} instructions/s "
        f"({sol.LANES_PER_SM_CLOCK} lanes a clock an SM at the max SM "
        f"clock); #9 separate issues {achieved:.5g} ALU instructions/s "
        f"({achieved / issue_rate:.4f} of it, -fmad=false), contracted "
        f"{contracted:.5g} ({contracted / issue_rate:.4f}); special-function "
        f"weights in ALU instructions "
        f"{({k: round(v, 3) for k, v in rates.weights.items()})}; launches "
        f"{got}")

    t0 = time.perf_counter()
    bunny, info = sp.create_bunny_scene(allow_download=False, device=device)
    mesh = sp.attach_packed(sp.create_mesh_scene(device=device))
    t_pack = time.perf_counter()
    # the superleaf packings, attached once outside the render calls
    bunny_sl = sp.attach_superleaf(bunny)
    bunny_mxu = sp.attach_mxu(bunny).wide
    mesh_sl, mesh_mxu = sp.attach_superleaf(mesh), sp.attach_mxu(mesh)
    log(f"[scene] superleaf packings in {time.perf_counter() - t_pack:.1f} "
        f"s: bunny {bunny_sl.wide.n_blocks} blocks "
        f"({coeff_bytes(bunny_mxu)} bytes), {bunny_sl.wide.n_pairs} pair records, depth "
        f"{bunny_sl.wide.depth}; mesh {mesh_sl.wide.n_blocks} blocks, "
        f"{mesh_sl.wide.n_pairs} pair records, depth {mesh_sl.wide.depth}")
    log(f"[scene] bunny {info}, pair records {bunny.packed.n_pairs}, tri "
        f"rows {bunny.packed.n_rows}, depth {bunny.packed.depth}, max leaf "
        f"{bunny.packed.max_leaf}, tables "
        f"{4 * (bunny.packed.pairs.numel() + bunny.packed.tri_rows.numel())}"
        f" bytes; mesh {mesh.triangles.count} triangles, depth "
        f"{mesh.packed.depth}, max leaf {mesh.packed.max_leaf}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    w, h = MAIN["width"], MAIN["height"]
    bunny_cam = sp.bunny_camera(w / h, device=device)
    mesh_cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                              aspect_ratio=1.0, device=device)
    mesh_wide_cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                   aspect_ratio=w / h, device=device)
    scenes = dict(
        bunny=(bunny, bunny_cam), mesh=(mesh, mesh_cam),
        bunny_sl=(bunny_sl, bunny_cam), mesh_sl=(mesh_sl, mesh_cam),
        mesh_mxu=(mesh_mxu, mesh_cam), mesh_mxu_wide=(mesh_mxu, mesh_wide_cam),
        demo=(sp.create_scene(device=device),
              sp.default_camera(w / h, device=device)),
        cornell=(sp.create_cornell_box(device=device),
                 sp.cornell_camera(w / h, device=device)),
        cornell_sq=(sp.create_cornell_box(device=device),
                    sp.cornell_camera(1.0, device=device)),
        dispersive=(dispersive_mesh(sp, device),
                    sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                   aspect_ratio=1.0, device=device)),
        lens=(sp.create_scene(device=device),
              sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                             aspect_ratio=2.0, aperture=0.2, focus_dist=3.0,
                             device=device)),
    )

    # ---- 2. each kernel against its plain version on the card
    sphere_checks = [compare_sphere(sp, mk, *case, device)
                     for case in SPHERE_CASES]
    rays = dict(random=random_rays(N_RANDOM_RAYS, device),
                primary=primary_rays(bunny_cam, w, h))
    isect_checks = [
        compare_intersect(
            f"bunny {key} rays",
            lambda o, d: bk.intersect_tile(bunny.packed, o, d),
            lambda o, d: bk.intersect_packed_plain(bunny.packed, o, d),
            *rays[key])
        for key in ("random", "primary")]
    mxu_isect_checks = [
        compare_intersect(
            f"#8 bunny {key} rays",
            lambda o, d: xk.intersect_tile_mxu(bunny_mxu, o, d),
            lambda o, d: xk.intersect_mxu_plain(bunny_mxu, o, d),
            *rays[key])
        for key in ("random", "primary")]
    mxu_renders = dict(mxu=(xk.render_flat_mxu_megakernel,
                            xk.render_flat_mxu_fused),
                       bvh_mxu=(bk.render_flat_bvh_mxu_megakernel,
                                lambda *a, **k: bk.render_flat_bvh_fused(
                                    *a, mxu_leaf=True, **k)))
    mxu_checks = []
    for name, engine, key, shape in MXU_CASES:
        scene, cam = scenes[key]
        kernel_fn, plain_fn = mxu_renders[engine]
        kernel = kernel_fn(scene, cam, **shape)
        plain = plain_fn(scene, cam, **shape)
        torch.cuda.synchronize()
        mxu_checks.append(check_images(name, kernel, plain, BVH_TOL))
    bvh_checks = []
    for name, key, shape in BVH_CASES:
        scene, cam = scenes[key]
        kernel = bk.render_flat_bvh_megakernel(scene, cam, **shape)
        plain = bk.render_flat_bvh_fused(scene, cam, **shape)
        torch.cuda.synchronize()
        bvh_checks.append(check_images(name, kernel, plain, BVH_TOL))
    counted_checks = check_counted(bk, bunny, bunny_cam)
    counted = counted_checks["counters_640x360_spp4_d4"]
    spectral_checks = []
    for name, key, shape, tol in SPECTRAL_CASES:
        scene, cam = scenes[key]
        kernel = sf.render_flat_spectral_megakernel(scene, cam, seed=7,
                                                    **shape)
        plain = sf.render_flat_fused_spectral(scene, cam, seed=7, **shape)
        torch.cuda.synchronize()
        spectral_checks.append(check_images(name, kernel, plain, tol))
    spectral_bvh_checks = []
    for name, key, shape in SPECTRAL_BVH_CASES:
        scene, cam = scenes[key]
        kernel = sb.render_flat_spectral_bvh_megakernel(scene, cam, **shape)
        plain = sb.render_flat_spectral_bvh_fused(scene, cam, **shape)
        torch.cuda.synchronize()
        spectral_bvh_checks.append(check_images(name, kernel, plain,
                                                BVH_TOL))
    grad_checks = []
    for name, key, shape, grad_spp, loss_mode in GRAD_CASES:
        scene, cam = scenes[key]
        if key == "demo":  # the demo camera at the case's aspect
            cam = sp.default_camera(shape["width"] / shape["height"],
                                    device=device)
        grad_checks.append(compare_grad(gk, mk, name, scene, cam, shape,
                                        grad_spp, loss_mode))
    m_shape = GRAD_CASES[0][2]
    fd_checks = check_finite_differences(
        sp, scenes["demo"][0],
        sp.default_camera(m_shape["width"] / m_shape["height"],
                          device=device), m_shape)

    # ---- 3. the main paths, through the user's entry points
    main_args = dict(samples_per_pixel=MAIN["spp"],
                     max_depth=MAIN["max_depth"])
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.save or tmp
        os.makedirs(out_dir, exist_ok=True)
        # the bunny, engine "auto" -> cuda_bvh
        def to_uint8(flat):
            return img_io.to_uint8(img_io.TONEMAPS["gamma"](
                img_io.assemble_image(flat, w, h)))

        shape_name = f"{w}x{h} spp{MAIN['spp']} d{MAIN['max_depth']}"
        png = os.path.join(out_dir, "chip_smoke_bunny.png")
        reset_counts()
        img = sp.render(bunny, bunny_cam, w, h, output_path=png, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_megakernel"] = got["bvh_megakernel"]
        check_main(f"bunny render {shape_name}", "bvh_megakernel", img,
                   to_uint8(bk.render_flat_bvh_fused(bunny, bunny_cam,
                                                     **MAIN)), got, png)

        # the counting build of #2 on the bunny: one launch, nothing else
        reset_counts()
        _, ctr = bk.render_bvh_with_counters(bunny, bunny_cam, **MAIN)
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_counted"] = got["bvh_counted"]
        want = dict.fromkeys(got, 0)
        want["bvh_counted"] = 1
        log(f"[main] bunny render_bvh_with_counters {shape_name}: "
            f"{ctr}, launches {got}")
        if got != want:
            raise AssertionError(f"render_bvh_with_counters launched {got}")

        # the nearest-hit query on the bunny's primary rays
        reset_counts()
        t, n, mid = bk.intersect_tile(bunny.packed, *rays["primary"])
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_intersect"] = got["bvh_intersect"]
        hits = t < 1e19
        log(f"[main] bunny primary rays {w}x{h}: {int(hits.sum())} hits, "
            f"{int((mid == 0).sum())} on the mesh, launches {got}")
        if got["bvh_intersect"] < 1:
            raise AssertionError("intersect path did not launch its kernel")
        if not (0 < int((mid == 0).sum()) < t.numel()):
            raise AssertionError("primary rays miss the bunny or hit all")

        # the sphere demo scene, engine "auto" -> cuda
        demo, demo_cam = scenes["demo"]
        png = os.path.join(out_dir, "chip_smoke_demo.png")
        reset_counts()
        img = sp.render(demo, demo_cam, w, h, output_path=png, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["megakernel"] = got["megakernel"]
        check_main(f"demo render {shape_name}", "megakernel", img,
                   sp.render(demo, demo_cam, w, h, engine="fused",
                             **main_args), got, png)

        # the spectral paths: the spectral kernel launched, no RGB kernel
        rgb_kernels = ("megakernel", "bvh_megakernel", "bvh_intersect")
        # the spectral Cornell box, engine "auto" -> cuda, spectral
        cornell, cornell_cam = scenes["cornell"]
        png = os.path.join(out_dir, "chip_smoke_cornell_spectral.png")
        reset_counts()
        img = sp.render(cornell, cornell_cam, w, h, output_path=png,
                        spectral=True, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["spectral_megakernel"] = got["spectral_megakernel"]
        check_main(f"spectral cornell render {shape_name}",
                   "spectral_megakernel", img,
                   sp.render(cornell, cornell_cam, w, h, engine="fused",
                             spectral=True, **main_args), got, png)
        if any(got[k] for k in rgb_kernels):
            raise AssertionError("spectral cornell path launched an RGB "
                                 "kernel")
        rgb_img = sp.render(cornell, cornell_cam, w, h, **main_args)
        rgb_gap = float(abs(img.astype(float) - rgb_img).mean())
        log(f"[main] spectral cornell against RGB cornell at the same "
            f"shape and seed: mean abs gap {rgb_gap:.4f} levels")
        if rgb_gap == 0.0:
            raise AssertionError("spectral cornell equals the RGB image")

        # the spectral bunny, engine "auto" -> cuda_spectral_bvh
        png = os.path.join(out_dir, "chip_smoke_bunny_spectral.png")
        reset_counts()
        img = sp.render(bunny, bunny_cam, w, h, output_path=png,
                        spectral=True, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["spectral_bvh_megakernel"] = got["spectral_bvh_megakernel"]
        check_main(f"spectral bunny render {shape_name}",
                   "spectral_bvh_megakernel", img,
                   to_uint8(sb.render_flat_spectral_bvh_fused(
                       bunny, bunny_cam, **MAIN)), got, png)
        if any(got[k] for k in rgb_kernels):
            raise AssertionError("spectral bunny path launched an RGB "
                                 "kernel")

        # the superleaf engines: one launch of their kernel, nothing else;
        # each image against its plain version at its own spp and against
        # cuda_bvh's image of the same scene and seed (same PCG stream,
        # another intersector)
        main_mxu_checks = []
        for what, kernel, engine, scene, cam, plain_fn, row_scene in (
                ("bunny", "bvh_mxu_megakernel", "cuda_bvh_mxu", bunny_sl,
                 bunny_cam, mxu_renders["bvh_mxu"][1], bunny),
                ("mesh", "mxu_megakernel", "cuda_mxu", mesh_mxu,
                 mesh_wide_cam, mxu_renders["mxu"][1], mesh)):
            png = os.path.join(out_dir, f"chip_smoke_{what}_{engine}.png")
            reset_counts()
            img = sp.render(scene, cam, w, h, output_path=png, engine=engine,
                            **main_args)
            torch.cuda.synchronize()
            got = counts()
            launches[kernel] = got[kernel]
            want = dict.fromkeys(got, 0)
            want[kernel] = 1
            if got != want:
                raise AssertionError(f"{what} render on {engine} launched "
                                     f"{got}, not {want}")
            plain = plain_fn(scene, cam, **MAIN)
            check_main(f"{what} render on {engine} {shape_name}", kernel,
                       img, to_uint8(plain), got, png)
            flat = sp.render_flat_engine(scene, cam, engine=engine, **MAIN)
            main_mxu_checks.append(check_images(
                f"{what} {engine} against its plain version {shape_name}",
                flat, plain, BVH_TOL))
            main_mxu_checks.append(check_images(
                f"{what} {engine} against cuda_bvh {shape_name}", flat,
                bk.render_flat_bvh_megakernel(row_scene, cam, **MAIN),
                BVH_TOL))

        # the streaming query on the bunny's primary rays, against the
        # packed-BVH query on the same rays
        reset_counts()
        t, n, mid = xk.intersect_tile_mxu(bunny_mxu, *rays["primary"])
        torch.cuda.synchronize()
        got = counts()
        launches["mxu_intersect"] = got["mxu_intersect"]
        want = dict.fromkeys(got, 0)
        want["mxu_intersect"] = 1
        log(f"[main] #8 bunny primary rays {w}x{h}: {int((t < 1e19).sum())}"
            f" hits, {int((mid == 0).sum())} on the mesh, launches {got}")
        if got != want:
            raise AssertionError(f"intersect_tile_mxu launched {got}")
        if not (0 < int((mid == 0).sum()) < t.numel()):
            raise AssertionError("primary rays miss the bunny or hit all")
        main_mxu_checks.append(compare_intersect(
            "#8 bunny primary rays against the packed-BVH query",
            lambda o, d: (t, n, mid),
            lambda o, d: bk.intersect_tile(bunny.packed, o, d),
            *rays["primary"]))

    # the differentiable step of bench.py: forward, MSE against a target
    # rendered at seed 7, backward; gradients for every material field
    step_target = mk.render_flat_megakernel(demo, demo_cam, seed=7, **MAIN)
    step_fields = ("albedo", "emission", "metallic", "roughness", "ior",
                   "transmission")

    def step(albedo, seed, grad_spp):
        leaves = {f: getattr(demo.materials, f).detach().clone()
                  .requires_grad_() for f in step_fields}
        leaves["albedo"] = albedo.detach().clone().requires_grad_()
        img = sp.render_flat_hybrid_grad(
            with_materials(demo, **leaves), demo_cam, seed=seed,
            grad_spp=grad_spp, **MAIN)
        loss = ((img - step_target) ** 2).mean()
        loss.backward()
        return loss.detach(), {f: v.grad for f, v in leaves.items()}

    albedo0 = demo.materials.albedo.clone()
    albedo0[:2] = torch.tensor(STEP_ALBEDO, device=device)
    launches["grad_megakernel"] = 0
    step_runs = {}
    for grad_spp in (MAIN["spp"], 4):
        albedo, losses = albedo0, []
        for seed in STEP_SEEDS:
            reset_counts()
            loss, grads = step(albedo, seed, grad_spp)
            torch.cuda.synchronize()
            got = counts()
            want = dict.fromkeys(got, 0)
            want.update(megakernel=1, grad_megakernel=1)
            if got != want:
                raise AssertionError(f"step (grad_spp {grad_spp}, seed "
                                     f"{seed}) launched {got}, not {want}")
            for f, g in grads.items():
                if not torch.isfinite(g).all():
                    raise AssertionError(f"step: {f} gradient not finite")
            for f in ("albedo", "emission"):
                if not (grads[f][:2].abs().amax(dim=1) > 0).all():
                    raise AssertionError(f"step: no {f} gradient on the "
                                         f"visible materials 0 and 1")
            launches["grad_megakernel"] += got["grad_megakernel"]
            losses.append(float(loss))
            albedo = (albedo - STEP_LR * grads["albedo"]).clamp(0.0, 1.0)
        step_runs[grad_spp] = dict(
            losses=losses, albedo_0_1=albedo[:2].tolist(),
            last_grad_albedo_0_1=grads["albedo"][:2].tolist())
        log(f"[main] step {w}x{h} spp{MAIN['spp']} d{MAIN['max_depth']} "
            f"grad_spp {grad_spp}: each of {len(losses)} steps one "
            f"megakernel and one grad_megakernel launch, no plain tracer "
            f"call; losses under gradient descent on the albedo (lr "
            f"{STEP_LR}): {[round(x, 6) for x in losses]}; albedo of "
            f"materials 0, 1 now {np.round(albedo[:2].tolist(), 4).tolist()}"
            f" (true {np.round(demo.materials.albedo[:2].tolist(), 4)})")
        if not losses[-1] < losses[0]:
            raise AssertionError("gradient descent did not lower the loss")

    # ---- 4. timing
    def mrays(shape, ms):
        rays_ = shape["width"] * shape["height"] * shape["spp"] \
            * shape["max_depth"]
        return rays_ / (ms * 1e-3) / 1e6

    def run(fn, scene, cam, shape):
        return lambda: fn(scene, cam, **shape)

    bvh_k = time_ms(run(bk.render_flat_bvh_megakernel, bunny, bunny_cam,
                        BVH_TIMED))
    bvh_p = time_ms(run(bk.render_flat_bvh_fused, bunny, bunny_cam,
                        BVH_TIMED), PLAIN_REPEATS)
    bvh_full = time_ms(run(bk.render_flat_bvh_megakernel, bunny, bunny_cam,
                           MAIN))
    log(f"[time] {card}: bunny 640x360 spp4 d4 kernel {bvh_k:.3f} ms "
        f"({mrays(BVH_TIMED, bvh_k):.1f} Mrays/s), plain {bvh_p:.3f} ms "
        f"({mrays(BVH_TIMED, bvh_p):.2f} Mrays/s), kernel/plain "
        f"{bvh_k / bvh_p:.5f}")
    log(f"[time] {card}: bunny 640x360 spp16 d4 kernel {bvh_full:.3f} ms "
        f"({mrays(MAIN, bvh_full):.1f} Mrays/s)")
    counted_k = time_ms(lambda: bk.render_bvh_with_counters(
        bunny, bunny_cam, **BVH_TIMED))
    counted_full = time_ms(lambda: bk.render_bvh_with_counters(
        bunny, bunny_cam, **MAIN))
    log(f"[time] {card}: bunny counting build spp4 d4 {counted_k:.3f} ms, "
        f"spp16 d4 {counted_full:.3f} ms: {counted_k / bvh_k:.4f} and "
        f"{counted_full / bvh_full:.4f} of the uncounted kernel's")
    peak_plain_ms = time_ms(lambda: vp.peak_plain(x_peak), PLAIN_REPEATS)
    x_dtype = vp.probe_input(probe["n_dtype"], device)
    dtype_plain_ms = time_ms(lambda: pp.vpu_dtype_plain(x_dtype),
                             PLAIN_REPEATS)
    log(f"[time] {card}: probes' plain versions at the fill grid: #9 "
        f"separate {peak_plain_ms:.3f} ms, #10 f32 {dtype_plain_ms:.3f} ms")
    isect_k = time_ms(lambda: bk.intersect_tile(bunny.packed,
                                                *rays["primary"]))
    isect_p = time_ms(lambda: bk.intersect_packed_plain(
        bunny.packed, *rays["primary"]), PLAIN_REPEATS)
    log(f"[time] {card}: bunny primary rays 640x360 intersect kernel "
        f"{isect_k:.4f} ms ({w * h / (isect_k * 1e-3) / 1e6:.1f} Mrays/s), "
        f"plain {isect_p:.3f} ms, kernel/plain {isect_k / isect_p:.5f}")
    sph_k = time_ms(run(mk.render_flat_megakernel, demo, demo_cam, MAIN))
    sph_p = time_ms(run(mk.render_flat_fused, demo, demo_cam, MAIN),
                    PLAIN_REPEATS)
    big = dict(width=1920, height=1080, spp=256, max_depth=4)
    sph_big = time_ms(run(mk.render_flat_megakernel, demo, demo_cam, big))
    log(f"[time] {card}: demo 640x360 spp16 d4 kernel {sph_k:.3f} ms "
        f"({mrays(MAIN, sph_k):.1f} Mrays/s), plain {sph_p:.3f} ms "
        f"({mrays(MAIN, sph_p):.1f} Mrays/s), kernel/plain "
        f"{sph_k / sph_p:.4f}")
    log(f"[time] {card}: demo 1920x1080 spp256 d4 kernel {sph_big:.3f} ms "
        f"({mrays(big, sph_big):.1f} Mrays/s)")
    spec_k = time_ms(run(sf.render_flat_spectral_megakernel, cornell,
                         cornell_cam, MAIN))
    spec_p = time_ms(run(sf.render_flat_fused_spectral, cornell,
                         cornell_cam, MAIN), PLAIN_REPEATS)
    # the RGB kernel on the same scene: what the spectral shading costs
    rgb_cornell = time_ms(run(mk.render_flat_megakernel, cornell,
                              cornell_cam, MAIN))
    log(f"[time] {card}: spectral cornell 640x360 spp16 d4 kernel "
        f"{spec_k:.3f} ms ({mrays(MAIN, spec_k):.1f} Mrays/s), plain "
        f"{spec_p:.3f} ms ({mrays(MAIN, spec_p):.2f} Mrays/s), kernel/plain "
        f"{spec_k / spec_p:.5f}; RGB kernel on the same scene "
        f"{rgb_cornell:.3f} ms")
    sbvh_k = time_ms(run(sb.render_flat_spectral_bvh_megakernel, bunny,
                         bunny_cam, BVH_TIMED))
    sbvh_p = time_ms(run(sb.render_flat_spectral_bvh_fused, bunny,
                         bunny_cam, BVH_TIMED), PLAIN_REPEATS)
    sbvh_full = time_ms(run(sb.render_flat_spectral_bvh_megakernel, bunny,
                            bunny_cam, MAIN))
    log(f"[time] {card}: spectral bunny 640x360 spp4 d4 kernel "
        f"{sbvh_k:.3f} ms ({mrays(BVH_TIMED, sbvh_k):.1f} Mrays/s), plain "
        f"{sbvh_p:.3f} ms ({mrays(BVH_TIMED, sbvh_p):.2f} Mrays/s), "
        f"kernel/plain {sbvh_k / sbvh_p:.5f}")
    log(f"[time] {card}: spectral bunny 640x360 spp16 d4 kernel "
        f"{sbvh_full:.3f} ms ({mrays(MAIN, sbvh_full):.1f} Mrays/s)")
    # the superleaf kernels, each beside cuda_bvh on the same call
    mxu_t = {}
    for name, kernel_fn, plain_fn, scene, row_scene, cam in (
            ("bvh_mxu_megakernel", bk.render_flat_bvh_mxu_megakernel,
             mxu_renders["bvh_mxu"][1], bunny_sl, bunny, bunny_cam),
            ("mxu_megakernel", xk.render_flat_mxu_megakernel,
             mxu_renders["mxu"][1], mesh_mxu, mesh, mesh_wide_cam)):
        mxu_t[name] = dict(
            ms=time_ms(run(kernel_fn, scene, cam, BVH_TIMED)),
            plain_ms=time_ms(run(plain_fn, scene, cam, BVH_TIMED),
                             PLAIN_REPEATS),
            full_ms=time_ms(run(kernel_fn, scene, cam, MAIN)),
            cuda_bvh_ms=time_ms(run(bk.render_flat_bvh_megakernel,
                                    row_scene, cam, BVH_TIMED)),
            cuda_bvh_full_ms=time_ms(run(bk.render_flat_bvh_megakernel,
                                         row_scene, cam, MAIN)))
        t_ = mxu_t[name]
        log(f"[time] {card}: {name} 640x360 spp4 d4 kernel {t_['ms']:.3f} "
            f"ms ({mrays(BVH_TIMED, t_['ms']):.1f} Mrays/s), plain "
            f"{t_['plain_ms']:.3f} ms, kernel/plain "
            f"{t_['ms'] / t_['plain_ms']:.5f}; spp16 d4 {t_['full_ms']:.3f} "
            f"ms ({mrays(MAIN, t_['full_ms']):.1f} Mrays/s); cuda_bvh on the "
            f"same calls {t_['cuda_bvh_ms']:.3f} and "
            f"{t_['cuda_bvh_full_ms']:.3f} ms")
    mxu_t["mxu_intersect"] = dict(
        ms=time_ms(lambda: xk.intersect_tile_mxu(bunny_mxu,
                                                 *rays["primary"])),
        plain_ms=time_ms(lambda: xk.intersect_mxu_plain(
            bunny_mxu, *rays["primary"]), PLAIN_REPEATS))
    t_ = mxu_t["mxu_intersect"]
    log(f"[time] {card}: #8 bunny primary rays 640x360 intersect kernel "
        f"{t_['ms']:.4f} ms ({w * h / (t_['ms'] * 1e-3) / 1e6:.1f} Mrays/s), "
        f"plain {t_['plain_ms']:.3f} ms, kernel/plain "
        f"{t_['ms'] / t_['plain_ms']:.5f}; the packed-BVH query on the same "
        f"rays {isect_k:.4f} ms")
    times = (bvh_k, bvh_p, bvh_full, counted_k, counted_full, peak_plain_ms,
             dtype_plain_ms, isect_k, isect_p, sph_k, sph_p, sph_big,
             spec_k, spec_p, rgb_cornell, sbvh_k, sbvh_p, sbvh_full,
             *(x for t_ in mxu_t.values() for x in t_.values()))
    if not all(math.isfinite(x) for x in times):
        raise AssertionError("timing failed")
    for name, k, p in (("bvh_megakernel", bvh_k, bvh_p),
                       ("bvh_intersect", isect_k, isect_p),
                       ("megakernel", sph_k, sph_p),
                       ("spectral_megakernel", spec_k, spec_p),
                       ("spectral_bvh_megakernel", sbvh_k, sbvh_p),
                       *((n_, t_["ms"], t_["plain_ms"])
                         for n_, t_ in mxu_t.items())):
        if k > p:
            log(f"[time] {name} is SLOWER than its plain version")
    # where the wrappers' time goes: the kernel against the small
    # table-packing launches before it, and the card's idle share
    bvh_prof = device_breakdown(run(bk.render_flat_bvh_megakernel, bunny,
                                    bunny_cam, MAIN))
    log_breakdown(card, "bunny 640x360 spp16 d4", bvh_prof)
    sph_prof = device_breakdown(run(mk.render_flat_megakernel, demo,
                                    demo_cam, MAIN))
    log_breakdown(card, "demo 640x360 spp16 d4", sph_prof)
    spec_prof = device_breakdown(run(sf.render_flat_spectral_megakernel,
                                     cornell, cornell_cam, MAIN))
    log_breakdown(card, "spectral cornell 640x360 spp16 d4", spec_prof)
    sbvh_prof = device_breakdown(run(sb.render_flat_spectral_bvh_megakernel,
                                     bunny, bunny_cam, MAIN))
    log_breakdown(card, "spectral bunny 640x360 spp16 d4", sbvh_prof)
    mxu_prof = dict(
        bvh_mxu_megakernel=device_breakdown(run(
            bk.render_flat_bvh_mxu_megakernel, bunny_sl, bunny_cam, MAIN)),
        mxu_megakernel=device_breakdown(run(
            xk.render_flat_mxu_megakernel, mesh_mxu, mesh_wide_cam, MAIN)))
    log_breakdown(card, "#2b bunny 640x360 spp16 d4",
                  mxu_prof["bvh_mxu_megakernel"])
    log_breakdown(card, "#7 mesh 640x360 spp16 d4",
                  mxu_prof["mxu_megakernel"])
    step_ms = {g: time_ms(lambda g=g: step(albedo0, 0, g))
               for g in (MAIN["spp"], 4)}
    for g, ms in step_ms.items():
        log(f"[time] {card}: differentiable step demo 640x360 spp16 d4 "
            f"grad_spp {g}: {ms:.3f} ms ({mrays(MAIN, ms):.1f} Mrays/s)")
    tables = [t.detach().contiguous() for t in mk.pack_tables(demo,
                                                               demo_cam)]
    cot = torch.rand(w * h, 3, generator=torch.Generator().manual_seed(5)
                     ).to(device)
    vjp_ms = {g: time_ms(lambda g=g: gk.render_grad_megakernel(
        demo, demo_cam, tables, cot, loss_mode=False, grad_spp=g, **MAIN))
        for g in (MAIN["spp"], 4)}
    # a zero cotangent skips every gradient atomicAdd and leaves the rest
    # of the work as it is: the atomics' share of the time
    zeros = torch.zeros_like(cot)
    vjp_zero_ms = time_ms(lambda: gk.render_grad_megakernel(
        demo, demo_cam, tables, zeros, loss_mode=False, grad_spp=MAIN["spp"],
        **MAIN))
    loss_k = time_ms(lambda: gk.render_grad_megakernel(
        demo, demo_cam, tables, step_target, loss_mode=True,
        grad_spp=MAIN["spp"], **MAIN))
    loss_p = grad_checks[4]["plain_ms_once"]
    log(f"[time] {card}: adjoint kernel alone, VJP mode 640x360 spp16 d4: "
        f"grad_spp 16 {vjp_ms[16]:.3f} ms (zero cotangent, no atomics: "
        f"{vjp_zero_ms:.3f} ms), grad_spp 4 {vjp_ms[4]:.3f} ms; "
        f"loss mode (forward at spp 16 + replay of 16) {loss_k:.3f} ms, "
        f"plain version (one call, case q) {loss_p:.3f} ms, kernel/plain "
        f"{loss_k / loss_p:.5f}")
    step_prof = device_breakdown(lambda: step(albedo0, 0, MAIN["spp"]))
    log_breakdown(card, "differentiable step 640x360 spp16 d4 exact "
                  "replay", step_prof)
    if not all(math.isfinite(x) for x in (*step_ms.values(),
                                          *vjp_ms.values(), vjp_zero_ms,
                                          loss_k)):
        raise AssertionError("timing failed")

    # ---- each kernel's bound, from the work this run's inputs need
    n_px = w * h
    sph_work = count_work(mk, "make_brute_intersect",
                          run(mk.render_flat_fused, demo, demo_cam, MAIN))
    # #2's inventory from its counting build; count_work's plain count of
    # the same render must agree with it
    bvh_work = dict(segments=counted["traversals"], hits=counted["hits"],
                    pops=counted["pops"], leaf_tris=counted["leaf_tris"],
                    blocks=0)
    bvh_plain_work = count_work(bk, "make_packed_intersect",
                                run(bk.render_flat_bvh_fused, bunny,
                                    bunny_cam, BVH_TIMED))
    log(f"[work] #2 bunny spp4: counting kernel {bvh_work}, count_work on "
        f"the plain version {bvh_plain_work}")
    if bvh_work != bvh_plain_work:
        raise AssertionError("#2: the counting kernel's inventory differs "
                             "from count_work's")
    spec_work = count_work(sf, "make_brute_intersect_spectral",
                           run(sf.render_flat_fused_spectral, cornell,
                               cornell_cam, MAIN))
    sbvh_work = count_work(sb, "make_packed_intersect_spectral",
                           run(sb.render_flat_spectral_bvh_fused, bunny,
                               bunny_cam, BVH_TIMED))
    isect_work = count_work(None, None, lambda: bk.intersect_packed_plain(
        bunny.packed, *rays["primary"]))
    bvh_mxu_work = count_work(bk, "make_packed_intersect", run(
        mxu_renders["bvh_mxu"][1], bunny_sl, bunny_cam, BVH_TIMED))
    mxu_work = count_work(xk, "make_mxu_stream_intersect", run(
        mxu_renders["mxu"][1], mesh_mxu, mesh_wide_cam, BVH_TIMED),
        stream_blocks=xk.n_blocks(mesh_mxu.wide))
    # the stream tests every block for every ray: no walk to count
    mxu_isect_work = dict(segments=w * h, hits=0, pops=0, leaf_tris=0,
                          blocks=w * h * xk.n_blocks(bunny_mxu))
    log(f"[work] on the timed inputs: demo {sph_work}, bunny spp4 "
        f"{bvh_work}, bunny primary rays {isect_work}, spectral cornell "
        f"{spec_work}, spectral bunny spp4 {sbvh_work}, #2b bunny spp4 "
        f"{bvh_mxu_work}, #7 mesh spp4 {mxu_work}, #8 bunny primary rays "
        f"{mxu_isect_work}")
    out_bytes = 12 * n_px
    bvh_tables = table_bytes(bunny.packed.pairs, bunny.packed.tri_rows)

    demo_tables = table_bytes(*tables)
    n_bunny_sph = bunny.spheres.count
    sph_units = sol.path_units(sph_work, n_px * MAIN["spp"],
                               demo.spheres.count, 0)
    bounds = dict(
        megakernel=sol_bound(sph_units, demo_tables + out_bytes, rates),
        bvh_megakernel=sol_bound(
            sol.path_units(bvh_work, n_px * BVH_TIMED["spp"], n_bunny_sph, 0,
                           bvh=True, form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        # bytes: the rays in, t, normal and material id out, the tables
        bvh_intersect=sol_bound(
            dict(ray=n_px, **sol.walk_units(isect_work, bunny.packed.form)),
            bvh_tables + n_px * (24 + 20), rates),
        spectral_megakernel=sol_bound(
            sol.path_units(spec_work, n_px * MAIN["spp"],
                           cornell.spheres.count, cornell.triangles.count,
                           spectral=True), out_bytes, rates),
        spectral_bvh_megakernel=sol_bound(
            sol.path_units(sbvh_work, n_px * BVH_TIMED["spp"], n_bunny_sph,
                           0, spectral=True, bvh=True,
                           form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        # loss mode at exact replay: the forward, the replay's forward,
        # and the reverse sweep of every replayed hit; bytes: tables,
        # target, gradient tables
        grad_megakernel=sol_bound(
            dict({u: 2 * n for u, n in sph_units.items()},
                 adjoint_hit=sph_work["hits"]),
            2 * demo_tables + out_bytes + 8, rates),
        bvh_mxu_megakernel=sol_bound(
            sol.path_units(bvh_mxu_work, n_px * BVH_TIMED["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs) + coeff_bytes(bunny_sl.wide)
            + out_bytes, rates),
        mxu_megakernel=sol_bound(
            sol.path_units(mxu_work, n_px * BVH_TIMED["spp"],
                           mesh_mxu.spheres.count, 0),
            coeff_bytes(mesh_mxu.wide) + out_bytes, rates),
        # bytes: the rays in, t, normal and material id out, the tables
        mxu_intersect=sol_bound(sol.walk_units(mxu_isect_work),
                            coeff_bytes(bunny_mxu) + n_px * (24 + 20),
                            rates),
        # the probes: their counted operations (one ALU instruction each,
        # in separate mode and in float32) at the issue rate; bytes: one
        # float32 in and out an element
        vpu_peak=price(dict(alu=vp.ops_per_launch("separate",
                                                  probe["n_peak"]),
                            bytes=8 * probe["n_peak"]), rates),
        vpu_dtype=price(dict(alu=pp.flops_per_launch(probe["n_dtype"]),
                             bytes=8 * probe["n_dtype"]), rates),
    )
    log(f"[bound] {card}: priced by utils/sol.py ({rates.source}): ALU "
        f"at the issue rate {rates.alu_per_s:.4g} instructions/s, special "
        f"functions at weights "
        f"{({k: round(v, 2) for k, v in rates.weights.items()})} ALU "
        f"instructions over the same rate, memory "
        f"{rates.hbm_bytes_per_s:.3g} B/s; beside each, for the record, the "
        f"data-sheet bound (every operation over "
        f"{sol.DATASHEET_F32_PER_S:.3g} FLOP/s)")
    for name, b in bounds.items():
        log(f"[bound] {card}: {name} {b['bound_ms']:.4f} ms, by "
            f"{b['bound_term']} (terms ms "
            f"{({k: round(v, 5) for k, v in b['bound_terms_ms'].items()})}"
            f"); data-sheet bound {b['datasheet_bound_ms']:.4f} ms")

    def bound_keys(name):
        b = bounds[name]
        # no single PyTorch call computes a path tracer, a BVH walk, its
        # adjoint or the probes' register chains
        return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None, bound_term=b["bound_term"],
                    bound_terms_ms=b["bound_terms_ms"],
                    datasheet_bound_ms=b["datasheet_bound_ms"])

    kernels = [
        {
            "name": "megakernel",
            "route": "cuda",
            **bound_keys("megakernel"),
            "source": "spira_tpu_torch/csrc/megakernel.cu",
            "replaces": "spira_tpu/kernels/megakernel.py:504",
            "launches": launches["megakernel"],
            "max_abs_err": sphere_checks[1]["max_abs_err"],
            "ms": sph_k,
            "plain_ms": sph_p,
            "shape": "demo 640x360 spp16 d4",
            "ms_1920x1080_spp256": sph_big,
            "profile_640x360_spp16_d4": sph_prof,
            "checks": sphere_checks,
        },
        {
            "name": "bvh_megakernel",
            "route": "cuda",
            **bound_keys("bvh_megakernel"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:1036",
            "launches": launches["bvh_megakernel"],
            "max_abs_err": bvh_checks[1]["max_abs_err"],
            "ms": bvh_k,
            "plain_ms": bvh_p,
            "shape": "bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": bvh_full,
            "mrays_640x360_spp16_d4": mrays(MAIN, bvh_full),
            "profile_640x360_spp16_d4": bvh_prof,
            "checks": bvh_checks,
            "ptxas": ptxas.get("bvh_megakernel", []),
            "counted_entry": "spira_bvh_megakernel_render_counted",
            "counted_launches": launches["bvh_counted"],
            "counted_ms": counted_k,
            "counted_ms_640x360_spp16_d4": counted_full,
            "counted_ptxas": ptxas.get("bvh_megakernel_counted", []),
            "counted_checks": counted_checks,
        },
        {
            "name": "bvh_intersect",
            "route": "cuda",
            **bound_keys("bvh_intersect"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:1134",
            "launches": launches["bvh_intersect"],
            "max_abs_err": isect_checks[1]["max_abs_err"],
            "ms": isect_k,
            "plain_ms": isect_p,
            "shape": "bunny primary rays 640x360",
            "checks": isect_checks,
        },
        {
            "name": "spectral_megakernel",
            "route": "cuda",
            **bound_keys("spectral_megakernel"),
            "source": "spira_tpu_torch/csrc/spectral_megakernel.cu",
            "replaces": "spira_tpu/kernels/spectral_fused.py:650",
            "launches": launches["spectral_megakernel"],
            "max_abs_err": spectral_checks[2]["max_abs_err"],
            "ms": spec_k,
            "plain_ms": spec_p,
            "shape": "spectral cornell 640x360 spp16 d4",
            "rgb_kernel_ms_same_scene": rgb_cornell,
            "profile_640x360_spp16_d4": spec_prof,
            "checks": spectral_checks,
        },
        {
            "name": "spectral_bvh_megakernel",
            "route": "cuda",
            **bound_keys("spectral_bvh_megakernel"),
            "source": "spira_tpu_torch/csrc/spectral_megakernel.cu",
            "replaces": "spira_tpu/kernels/spectral_bvh.py:155",
            "launches": launches["spectral_bvh_megakernel"],
            "max_abs_err": spectral_bvh_checks[1]["max_abs_err"],
            "ms": sbvh_k,
            "plain_ms": sbvh_p,
            "shape": "spectral bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": sbvh_full,
            "mrays_640x360_spp16_d4": mrays(MAIN, sbvh_full),
            "profile_640x360_spp16_d4": sbvh_prof,
            "checks": spectral_bvh_checks,
        },
        {
            "name": "grad_megakernel",
            "route": "cuda",
            **bound_keys("grad_megakernel"),
            "source": "spira_tpu_torch/csrc/grad_megakernel.cu",
            "replaces": "spira_tpu/kernels/grad_megakernel.py:57",
            "launches": launches["grad_megakernel"],
            "max_abs_err": max(c["max_abs_err"] for c in grad_checks),
            "ms": loss_k,
            "plain_ms": loss_p,
            "shape": "loss mode, demo 640x360 spp16 d4, exact replay",
            "vjp_ms_grad_spp16": vjp_ms[16],
            "vjp_ms_grad_spp4": vjp_ms[4],
            "vjp_ms_grad_spp16_zero_cotangent": vjp_zero_ms,
            "step_ms_grad_spp16": step_ms[16],
            "step_ms_grad_spp4": step_ms[4],
            "step_mrays_grad_spp16": mrays(MAIN, step_ms[16]),
            "step_mrays_grad_spp4": mrays(MAIN, step_ms[4]),
            "step_profile_640x360_spp16_d4": step_prof,
            "step_runs": step_runs,
            "ptxas": ptxas.get("grad_megakernel", []),
            "checks": grad_checks,
            "finite_differences": fd_checks,
        },
        {
            "name": "mxu_megakernel",
            "route": "cuda",
            **bound_keys("mxu_megakernel"),
            "source": "spira_tpu_torch/csrc/mxu_megakernel.cu",
            "replaces": "spira_tpu/kernels/mxu_megakernel.py:205",
            "launches": launches["mxu_megakernel"],
            "max_abs_err": max(c["max_abs_err"] for c in mxu_checks[:2]),
            "ms": mxu_t["mxu_megakernel"]["ms"],
            "plain_ms": mxu_t["mxu_megakernel"]["plain_ms"],
            "shape": "mesh (1,600 triangles) 640x360 spp4 d4",
            "ms_640x360_spp16_d4": mxu_t["mxu_megakernel"]["full_ms"],
            "cuda_bvh_ms_same_call": mxu_t["mxu_megakernel"]["cuda_bvh_ms"],
            "cuda_bvh_ms_640x360_spp16_d4": (
                mxu_t["mxu_megakernel"]["cuda_bvh_full_ms"]),
            "profile_640x360_spp16_d4": mxu_prof["mxu_megakernel"],
            "checks": mxu_checks[:2] + main_mxu_checks[2:4],
        },
        {
            "name": "mxu_intersect",
            "route": "cuda",
            **bound_keys("mxu_intersect"),
            "source": "spira_tpu_torch/csrc/mxu_megakernel.cu",
            "replaces": "spira_tpu/kernels/mxu_megakernel.py:284",
            "launches": launches["mxu_intersect"],
            "max_abs_err": mxu_isect_checks[1]["max_abs_err"],
            "ms": mxu_t["mxu_intersect"]["ms"],
            "plain_ms": mxu_t["mxu_intersect"]["plain_ms"],
            "shape": "bunny primary rays 640x360",
            "bvh_intersect_ms_same_rays": isect_k,
            "checks": mxu_isect_checks + main_mxu_checks[4:],
        },
        {
            "name": "bvh_mxu_megakernel",
            "route": "cuda",
            **bound_keys("bvh_mxu_megakernel"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "leaf_source": "spira_tpu_torch/csrc/superleaf.cuh",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:252",
            "launches": launches["bvh_mxu_megakernel"],
            "max_abs_err": mxu_checks[3]["max_abs_err"],
            "ms": mxu_t["bvh_mxu_megakernel"]["ms"],
            "plain_ms": mxu_t["bvh_mxu_megakernel"]["plain_ms"],
            "shape": "bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": mxu_t["bvh_mxu_megakernel"]["full_ms"],
            "cuda_bvh_ms_same_call": (
                mxu_t["bvh_mxu_megakernel"]["cuda_bvh_ms"]),
            "cuda_bvh_ms_640x360_spp16_d4": (
                mxu_t["bvh_mxu_megakernel"]["cuda_bvh_full_ms"]),
            "profile_640x360_spp16_d4": mxu_prof["bvh_mxu_megakernel"],
            "checks": mxu_checks[2:] + main_mxu_checks[:2],
        },
        {
            "name": "vpu_peak",
            "route": "cuda",
            **bound_keys("vpu_peak"),
            "source": "spira_tpu_torch/csrc/peak.cu",
            "replaces": "benchmarks/vpu_peak.py:31",
            "launches": launches["vpu_peak"],
            "max_abs_err": max(c["max_abs_err"] for c in peak_checks),
            "ms": peak_ms["separate"],
            "plain_ms": peak_plain_ms,
            "shape": f"{probe['n_peak']} elements x {vp.CHAINS} chains x "
                     f"{vp.ITERS} iterations, mode separate",
            "ms_by_mode": peak_ms,
            "rates_by_mode": peak_rates,
            "instructions_per_chain_iteration": vp.INSTRUCTIONS,
            "sol_rates": rates.as_dict(),
            "issue_rate": issue_rate,
            "checks": peak_checks,
        },
        {
            "name": "vpu_dtype",
            "route": "cuda",
            **bound_keys("vpu_dtype"),
            "source": "spira_tpu_torch/csrc/peak.cu",
            "replaces": "benchmarks/packet_profile.py:94",
            "launches": launches["vpu_dtype"],
            "max_abs_err": max(c["max_abs_err"] for c in dtype_checks),
            "ms": dtype_ms[("fill", "f32")],
            "plain_ms": dtype_plain_ms,
            "shape": f"{probe['n_dtype']} elements x {pp.CHAIN} steps, f32",
            "bf16_ms": dtype_ms[("fill", "bf16")],
            "gflop_s_fill": {r["dtype"]: r["gflop_s"] for r in dtype_rows
                             if r["grid"] == "fill"},
            "rows": dtype_rows,
            "checks": dtype_checks,
        },
    ]
    # share of the bound at the timed shape, and the redesign ranking:
    # launches on the main path x (time - bound), largest first
    for k in kernels:
        k["share_of_bound_pct"] = sol.sol_pct(k["bound_ms"], k["ms"])
        k["rank_ms"] = k["launches"] * (k["ms"] - k["bound_ms"])
    for k in sorted(kernels, key=lambda k: -k["rank_ms"]):
        log(f"[rank] {card}: {k['name']}: {k['launches']} launches x "
            f"({k['ms']:.4f} - {k['bound_ms']:.4f} ms) = {k['rank_ms']:.3f} "
            f"ms; {k['share_of_bound_pct']:.3f}% of its bound, by "
            f"{k['bound_term']}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
