"""Times of the adjoint kernel (#6) and of the differentiable steps on the
card.

    python3 spira_tpu_torch/bench/grad_step.py [--root DIR] [--out PATH]
    python3 spira_tpu_torch/bench/grad_step.py --mesh [--designs] [--out PATH]

The step of ``bench.py``: the sphere demo at 640x360, spp 16, depth 4.
Timed with CUDA events (``timing.cuda_ms``: a warm-up, then the median of
10): the VJP kernel at grad_spp 16 and 4 on a seeded random cotangent,
and at grad_spp 16 on a zero cotangent (no gradient adds at all: the gap
to it is what the adds cost); loss mode at exact replay; and the step
(:func:`step`) at both grad_spp.  Then ``torch.profiler``'s time on the
card by kernel name, over 5 loss-mode calls and 5 steps, and ``ptxas
-v`` of the two libraries the step loads.

``--mesh`` times the mesh step of ``bench.py``'s mesh tier instead
(:func:`measure_mesh`): ``render_flat_hybrid_grad_mesh`` on the bunny
(``create_bunny_scene``'s 72,960-triangle stand-in) at 640x360, spp 16,
depth 4, ``grad_spp=2``, ``loss = img.mean()``, the gradient to the
material albedo; and spectrally, to ``albedo_spd``.  For each: the step,
its forward and its backward with CUDA events (a warm-up, then the median
of 5 steps), the kernels' launches in a step (#2 or #5, #3), the time on
the card by kernel, the device operations and the idle share of one
profiled step (``torch.profiler``); the backward's replay by hand
(``render.mesh_replay``'s vector-Jacobian product), its time (median of
3) and the peak of ``torch.cuda.max_memory_allocated`` over it, beside
the step's.  ``--mesh --designs`` times the step and that replay instead
with each replayed sample a checkpoint and with none
(:func:`measure_replay_designs`), the choice behind
``render.REPLAY_CHECKPOINT``.

``--root`` imports ``spira_tpu_torch`` from another checkout (a ``git
archive`` of another commit unpacked into a directory ``.gitignore``
lists), so that one call on one card times two commits' kernels with the
same script; the calls it makes have the same signatures at every commit
since the step was ported.  Prints one JSON line (and appends it to
``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import re
import statistics
import sys
from pathlib import Path

import torch

SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
GRAD_SPPS = (16, 4)
#: the material fields the step differentiates
FIELDS = ("albedo", "emission", "metallic", "roughness", "ior",
          "transmission")


def step(sp, scene, cam, target, albedo, seed, grad_spp, shape=SHAPE):
    """One step: forward (``render_flat_hybrid_grad``), MSE against
    ``target``, backward; every field of :data:`FIELDS` a leaf, the albedo
    a copy of ``albedo``.  Returns the loss and ``{field: gradient}``."""
    leaves = {f: getattr(scene.materials, f).detach().clone()
              .requires_grad_() for f in FIELDS}
    leaves["albedo"] = albedo.detach().clone().requires_grad_()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, **leaves))
    img = sp.render_flat_hybrid_grad(scene, cam, seed=seed,
                                     grad_spp=grad_spp, **shape)
    loss = ((img - target) ** 2).mean()
    loss.backward()
    return loss.detach(), {f: v.grad for f, v in leaves.items()}


def kernels_ms(fn, runs=5):
    """Time on the card by kernel name, ms per ``fn()`` call, over
    ``runs`` calls after a warm-up (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.split(r"[<(]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / runs / 1e3)
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def measure(device):
    """The times above, for the ``spira_tpu_torch`` on ``sys.path``."""
    import spira_tpu_torch as sp
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import grad_megakernel as gk
    from spira_tpu_torch.kernels import megakernel as mk

    w, h = SHAPE["width"], SHAPE["height"]
    scene = sp.create_scene(device=device)
    cam = sp.default_camera(w / h, device=device)
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    cot = torch.rand(w * h, 3, generator=torch.Generator().manual_seed(5)
                     ).to(device)
    target = mk.render_flat_megakernel(scene, cam, seed=7, **SHAPE)

    def vjp(grad_spp, c=cot):
        return lambda: gk.render_grad_megakernel(
            scene, cam, tables, c, loss_mode=False, grad_spp=grad_spp,
            **SHAPE)

    def loss():
        return gk.render_grad_megakernel(
            scene, cam, tables, target, loss_mode=True,
            grad_spp=SHAPE["spp"], **SHAPE)

    def run_step(grad_spp):
        return lambda: step(sp, scene, cam, target, scene.materials.albedo,
                            0, grad_spp)

    return dict(
        vjp_ms={g: cuda_ms(vjp(g)) for g in GRAD_SPPS},
        vjp_zero_cotangent_ms=cuda_ms(vjp(GRAD_SPPS[0],
                                          torch.zeros_like(cot))),
        loss_ms=cuda_ms(loss),
        step_ms={g: cuda_ms(run_step(g)) for g in GRAD_SPPS},
        loss_kernels_ms=kernels_ms(loss),
        step_kernels_ms=kernels_ms(run_step(GRAD_SPPS[0])),
    )


MESH_SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
MESH_GRAD_SPP = 2
#: the mesh step's leaf: bench.py's albedo, spectrally the albedo's SPD
MESH_LEAF = {False: "albedo", True: "albedo_spd"}
MESH_RUNS = 5


def mesh_leaves(scene, cam, fields):
    """Fresh leaves (copies that require grad) of ``fields``."""
    return {(g, f): getattr(cam if g == "camera" else getattr(scene, g), f)
            .detach().clone().requires_grad_() for g, f in fields}


def mesh_step(sp, scene, cam, *, seed=0, spectral=False, shape=MESH_SHAPE,
              fields=None):
    """One step of ``bench.py``'s mesh tier: the forward
    (``render_flat_hybrid_grad_mesh`` at ``grad_spp=2``), the loss
    (``img.mean()``), the backward.  ``fields``: the (group, field)
    leaves, the material albedo (its SPD spectrally) by default.  Returns
    (loss, image, {(group, field): gradient})."""
    from spira_tpu_torch.render import with_fields

    fields = fields or (("materials", MESH_LEAF[spectral]),)
    leaves = mesh_leaves(scene, cam, fields)
    sc, cm = with_fields(scene, cam, leaves)
    img = sp.render_flat_hybrid_grad_mesh(sc, cm, seed=seed,
                                          grad_spp=MESH_GRAD_SPP,
                                          spectral=spectral, **shape)
    loss = img.mean()
    loss.backward()
    return loss.detach(), img.detach(), {k: v.grad for k, v in leaves.items()}


def mesh_replay_grads(scene, cam, cotangent, fields, *, seed=0,
                      spectral=False, shape=MESH_SHAPE, query=None):
    """The mesh step's backward by hand: the vector-Jacobian product of
    ``render.mesh_replay`` (the packet provider over ``query``) at
    ``cotangent``: {(group, field): gradient}."""
    from spira_tpu_torch.render import mesh_replay, with_fields

    leaves = mesh_leaves(scene, cam, fields)
    sc, cm = with_fields(scene, cam, leaves)
    out = mesh_replay(sc, cm, width=shape["width"], height=shape["height"],
                      grad_spp=MESH_GRAD_SPP, max_depth=shape["max_depth"],
                      seed=seed, spectral=spectral, query=query)
    grads = torch.autograd.grad(out, list(leaves.values()), cotangent)
    return dict(zip(leaves, grads))


def peak_mb(fn):
    """The peak of ``torch.cuda.max_memory_allocated`` over ``fn()``, above
    what was allocated before it, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def measure_replay_designs(scene, cam, spectral, shape=MESH_SHAPE):
    """The step and its replay by hand (:func:`mesh_replay_grads`) with
    each replayed sample a checkpoint and with none
    (``render.REPLAY_CHECKPOINT`` set for the run), in the order on, off,
    on, off: their times (median of 5 after a warm-up), peak memory, #3's
    launches in a step, and whether the two designs' gradients agree to
    the bit."""
    import importlib

    import spira_tpu_torch as sp
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import bvh_megakernel as bk

    # the module, not the package's ``render`` function of the same name
    render = importlib.import_module("spira_tpu_torch.render")

    field = ("materials", MESH_LEAF[spectral])
    n = shape["width"] * shape["height"]
    cot = torch.full((n, 3), 1.0 / (3 * n), device=cam.origin.device)
    out = dict(spectral=spectral, shape=shape, grad_spp=MESH_GRAD_SPP,
               leaf=field[1])
    grads = {}
    kept = render.REPLAY_CHECKPOINT
    try:
        for ck in (True, False, True, False):
            render.REPLAY_CHECKPOINT = ck
            name = "checkpoint" if ck else "no_checkpoint"

            def replay():
                return mesh_replay_grads(scene, cam, cot, (field,),
                                         spectral=spectral, shape=shape)

            def step():
                return mesh_step(sp, scene, cam, spectral=spectral,
                                 shape=shape)

            for key, fn in (("step", step), ("replay", replay)):
                out.setdefault(f"{key}_ms_{name}", []).append(cuda_ms(fn, 5))
                out.setdefault(f"peak_mb_{key}_{name}", []).append(
                    peak_mb(fn))
            bk.intersect_tile.launches = 0
            step()
            out.setdefault(f"intersect_launches_{name}", []).append(
                bk.intersect_tile.launches)
            grads[ck] = replay()[field]
    finally:
        render.REPLAY_CHECKPOINT = kept
    out["bit_equal"] = bool(torch.equal(grads[True], grads[False]))
    return out


def measure_mesh(scene, cam, spectral):
    """The mesh step's numbers (module docstring) for one transport."""
    import spira_tpu_torch as sp
    from spira_tpu_torch.bench.mesh_frame import profile_call
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import spectral_bvh as sb
    from spira_tpu_torch.render import with_fields

    forward_kernel = (sb.render_flat_spectral_bvh_megakernel if spectral
                      else bk.render_flat_bvh_megakernel)
    field = ("materials", MESH_LEAF[spectral])

    def step():
        return mesh_step(sp, scene, cam, spectral=spectral)

    step()  # builds the kernels, fills the device constants
    forward_kernel.launches = bk.intersect_tile.launches = 0
    _, img, grads = step()
    torch.cuda.synchronize()
    launches = dict(forward=forward_kernel.launches,
                    intersect=bk.intersect_tile.launches)
    fwd_ms, bwd_ms, step_ms = [], [], []
    for _ in range(MESH_RUNS):
        leaves = mesh_leaves(scene, cam, (field,))
        sc, cm = with_fields(scene, cam, leaves)
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        out = sp.render_flat_hybrid_grad_mesh(
            sc, cm, grad_spp=MESH_GRAD_SPP, spectral=spectral, **MESH_SHAPE)
        events[1].record()
        out.mean().backward()
        events[2].record()
        torch.cuda.synchronize()
        fwd_ms.append(events[0].elapsed_time(events[1]))
        bwd_ms.append(events[1].elapsed_time(events[2]))
        step_ms.append(events[0].elapsed_time(events[2]))
    prof = profile_call(step, runs=1)
    cot = torch.full_like(img, 1.0 / img.numel())
    n_px = MESH_SHAPE["width"] * MESH_SHAPE["height"]
    return dict(
        spectral=spectral, shape=MESH_SHAPE, grad_spp=MESH_GRAD_SPP,
        leaf=field[1], launches_per_step=launches,
        step_ms=statistics.median(step_ms), forward_ms=statistics.median(
            fwd_ms), backward_ms=statistics.median(bwd_ms),
        step_ms_runs=step_ms,
        mrays_per_s=n_px * MESH_SHAPE["spp"] * MESH_SHAPE["max_depth"]
        / (statistics.median(step_ms) * 1e-3) / 1e6,
        device_ms=prof["device_ms"], profiled_wall_ms=prof["wall_ms"],
        idle_share=1.0 - prof["device_ms"] / statistics.median(step_ms),
        device_ops=prof["device_ops"],
        top_kernels_ms=dict(list(prof["kernels_ms"].items())[:8]),
        kernel_launches_profiled={k: v for k, v in prof["launches"].items()
                                  if k.startswith("spira::")},
        replay_ms=cuda_ms(lambda: mesh_replay_grads(
            scene, cam, cot, (field,), spectral=spectral), 3),
        peak_mb_step=peak_mb(step),
        peak_mb_replay=peak_mb(lambda: mesh_replay_grads(
            scene, cam, cot, (field,), spectral=spectral)),
        grad_abs_max=float(grads[field].abs().max()),
        grad_finite=bool(torch.isfinite(grads[field]).all()),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="the checkout whose spira_tpu_torch to time "
                    "(default: this one)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--mesh", action="store_true",
                    help="time the mesh step instead (this checkout)")
    ap.add_argument("--designs", action="store_true",
                    help="with --mesh: time the step's replay with each "
                    "sample a checkpoint and with none")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import timing

    device = timing.require_cuda("grad_step")
    if args.mesh:
        import spira_tpu_torch as sp

        scene, _ = sp.create_bunny_scene(allow_download=False, device=device)
        cam = sp.bunny_camera(MESH_SHAPE["width"] / MESH_SHAPE["height"],
                              device=device)
        if args.designs:
            timing.record(args.out, script="grad_step --mesh --designs",
                          card=timing.card_line(), root=str(root),
                          designs=[measure_replay_designs(scene, cam, spectral)
                                   for spectral in (False, True)])
            return 0
        timing.record(args.out, script="grad_step --mesh",
                      card=timing.card_line(), root=str(root),
                      steps=[measure_mesh(scene, cam, spectral)
                             for spectral in (False, True)])
        return 0
    source = root / "spira_tpu_torch" / "csrc" / "grad_megakernel.cu"
    times = measure(device)
    # ptxas -v of the two libraries the step loads (built by this process
    # unless the checkout had them cached)
    ptxas = {name: [line.strip() for line in _build.load(name).log
                    .splitlines() if "registers" in line or "spill" in line
                    or "entry function" in line]
             for name in ("megakernel", "grad_megakernel")}
    timing.record(args.out, script="grad_step", card=timing.card_line(),
                  root=str(root),
                  grad_megakernel_sha256=hashlib.sha256(
                      source.read_bytes()).hexdigest()[:16],
                  shape=SHAPE, ptxas=ptxas, **times)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
