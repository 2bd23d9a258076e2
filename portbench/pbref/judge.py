"""The reference's side of a run: what the program should have produced,
worked out again from the configuration, the benchmark's own arrays and
the seeds, in the precision asked for (float32 for the reference,
bfloat16 for the control).  It imports nothing of the program and reads
none of its outputs; the harness compares the two afterwards."""

from __future__ import annotations

import numpy as np
import torch

from . import bvh, mesh, plugin
from .scene import make_camera, make_scene

#: lanes a batch of the reference's tracer holds (a frame's forward)
LANES = 1 << 22


def scene_for(cfg, parts, device, dtype=torch.float32):
    tri = (mesh.triangle_arrays(parts, cfg["mesh"]["material"])
           if parts else None)
    scene = make_scene(cfg, tri, device, dtype)
    if scene.tris:
        scene.bvh = bvh.build(scene.tris, dtype)
    return scene


def tonemap_uint8(hdr, tonemap: str) -> np.ndarray:
    """The tone map ``tonemaps/<tonemap>.py`` then ``io/image.py``'s
    ``to_uint8`` (frozen at commit 86df806): ``clip(x * 255 + 0.5, 0,
    255)`` truncated to uint8 on the host."""
    ldr = plugin("tonemaps", tonemap).apply(hdr).float().cpu().numpy()
    return np.asarray(np.clip(ldr * 255.0 + 0.5, 0.0, 255.0),
                      dtype=np.uint8)


def frame_pixels(cfg, parts, mix, pixels, seeds, device,
                 dtype=torch.float32, counts=None):
    """The uint8 values, (P, 3) for each of ``seeds``, of the bottom-up
    flat ``pixels`` of the frames the mix renders at those seeds, by the
    mix's ``estimator`` (``estimators/<name>.py``, ``kernel`` unless
    named)."""
    w, h = mix["width"], mix["height"]
    scene = scene_for(cfg, parts, device, dtype)
    cam = make_camera(cfg["camera"], w / h, device, dtype)
    pix = torch.as_tensor(np.asarray(pixels), device=device).long()
    estimator = plugin("estimators", mix.get("estimator", "kernel"))
    with torch.no_grad():
        hdr = estimator.render_pixels(
            scene, cam, pix, width=w, height=h, spp=mix["spp"],
            max_depth=mix["max_depth"], seeds=seeds, lanes=LANES,
            counts=counts)
    out = [tonemap_uint8(x, mix["tonemap"]) for x in hdr]
    return out, dict(pixels=len(pix) * len(seeds))


def follow_steps(cfg, parts, mix, step_seeds, target_seed, device,
                 dtype=torch.float32, counts=None):
    """The mix's first steps from the mix's starting leaves: each step's
    loss, the first step's gradients, and the leaves after the last.

    The forward is the mix's ``estimator`` (``estimators/<name>.py``,
    ``kernel`` unless named), the loss the MSE against the target (the
    true materials at ``target_seed``); the gradient is the estimator
    the mix's ``gradient`` names (``gradients/<name>.py``).  Then
    ``torch.optim.Adam`` and each leaf's ``clamp`` ([low, high], either
    null for none)."""
    w, h, spp = mix["width"], mix["height"], mix["spp"]
    depth = mix["max_depth"]
    scene = scene_for(cfg, parts, device, dtype)
    cam = make_camera(cfg["camera"], w / h, device, dtype)
    pix = torch.arange(w * h, device=device)
    forward = plugin("estimators", mix.get("estimator", "kernel"))
    gradient = plugin("gradients", mix["gradient"])
    with torch.no_grad():
        target = forward.render_pixels(scene, cam, pix, width=w, height=h,
                                       spp=spp, max_depth=depth,
                                       seeds=[target_seed], lanes=LANES)[0]
    leaves = {k: torch.full_like(scene.materials[k], v["start"])
              .requires_grad_(True) for k, v in mix["leaves"].items()}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=mix["lr"],
                           foreach=False)
    losses, first = [], None
    for k, seed in enumerate(step_seeds):
        with torch.no_grad():
            sc = scene.with_materials(
                **{n: v.detach() for n, v in leaves.items()})
            img = forward.render_pixels(sc, cam, pix, width=w, height=h,
                                        spp=spp, max_depth=depth,
                                        seeds=[seed], lanes=LANES,
                                        counts=counts if k == 0 else None)[0]
            diff = img - target
            losses.append(float(torch.mean(diff.float() ** 2)))
            cot = 2.0 * diff / diff.numel()
        grads = gradient.grads(scene, cam, leaves, cot, mix, seed)
        for p, g in zip(leaves.values(), grads):
            p.grad = torch.zeros_like(p) if g is None else g.detach()
        if k == 0:
            first = {n: p.grad.clone() for n, p in leaves.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, p in leaves.items():
                low, high = mix["leaves"][n]["clamp"]
                if low is not None or high is not None:
                    p.clamp_(min=low, max=high)
    return dict(losses=losses, first_grads=first, start=start,
                after={n: p.detach().clone() for n, p in leaves.items()})
