"""Times of the adjoint kernel (#6) and of the differentiable step on the
card.

    python3 spira_tpu_torch/bench/grad_step.py [--root DIR] [--out PATH]

The step of ``bench.py``: the sphere demo at 640x360, spp 16, depth 4.
Timed with CUDA events (``timing.cuda_ms``: a warm-up, then the median of
10): the VJP kernel at grad_spp 16 and 4 on a seeded random cotangent,
and at grad_spp 16 on a zero cotangent (no gradient adds at all: the gap
to it is what the adds cost); loss mode at exact replay; and the step
(:func:`step`) at both grad_spp.  Then ``torch.profiler``'s time on the
card by kernel name, over 5 loss-mode calls and 5 steps, and ``ptxas
-v`` of the two libraries the step loads.

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

    device = timing.require_cuda("grad_step")
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
