"""Inverse rendering: the twin of ``examples/inverse_rendering.py``.
Recover perturbed material albedos and the light's emission from a
rendered target (spp 32, seed 1234) through the wavefront's gradients and
Adam at 3e-2; 96x54, spp 4, depth 4.

    python -m spira_tpu_torch.examples.inverse_rendering [steps]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import spira_tpu_torch as sp
from spira_tpu_torch.io import image as img_io


def run(steps: int = 150, *, width: int = 96, height: int = 54, spp: int = 4,
        max_depth: int = 4, target_spp: int = 32, target_seed: int = 1234,
        learning_rate: float = 3e-2, out: str | None = None, log=None,
        device="cuda"):
    """Run ``steps`` Adam steps from albedo 0.5 and emission 1 towards
    the demo's render; returns the parameters, the losses a step (floats)
    and the true (albedo, emission).  ``log(it, loss, albedo_err)`` is
    called every 10 steps; ``out`` writes the last parameters' render."""
    scene = sp.create_scene(device=device)
    camera = sp.default_camera(width / height, device=device)
    true_albedo = scene.materials.albedo
    true_emission = scene.materials.emission
    target = sp.render_flat(scene, camera, width=width, height=height,
                            spp=target_spp, max_depth=max_depth,
                            seed=target_seed)
    step, init = sp.make_inverse_step(width=width, height=height, spp=spp,
                                      max_depth=max_depth,
                                      learning_rate=learning_rate)
    params = {"albedo": torch.full_like(true_albedo, 0.5),
              "emission": torch.zeros_like(true_emission) + 1.0}
    opt_state = init(params)
    losses = []
    for it in range(steps):
        params, opt_state, loss = step(params, opt_state, scene, camera,
                                       target, it)
        losses.append(loss)
        if log is not None and it % 10 == 0:
            err = float((params["albedo"].detach() - true_albedo).abs().mean())
            log(it, float(loss), err)
    losses = [float(x) for x in losses]  # one host copy, after the loop
    if out is not None:
        from spira_tpu_torch.diff.inverse import render_for_grad

        with torch.no_grad():
            img = render_for_grad(params, scene, camera, width=width,
                                  height=height, spp=spp,
                                  max_depth=max_depth, seed=steps)
        img_io.save_png(out, img_io.to_uint8(img_io.tonemap_gamma(
            img_io.assemble_image(img, width, height))))
    return params, losses, (true_albedo, true_emission)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 150

    def log(it, loss, err):
        print(f"step {it:4d}  loss {loss:.6f}  albedo err {err:.4f}")

    params, _, (true_albedo, _) = run(steps, log=log)
    print("\nrecovered albedo vs truth:")
    for i, (a, b) in enumerate(zip(params["albedo"].detach().cpu().numpy(),
                                   true_albedo.cpu().numpy())):
        print(f"  material {i}: {np.round(a, 3)}  vs  {np.round(b, 3)}")
    print("recovered emission (light should be ~[5,5,5]):")
    print(np.round(params["emission"].detach().cpu().numpy(), 2))


if __name__ == "__main__":
    main()
