"""Depth-of-field render: the twin of ``examples/dof_render.py``, a
thin-lens camera with a wide aperture (0.35) focused on the center sphere
(3.2), 640x360, spp 64, depth 4.  The kernel samples the lens disk from
the raygen draw's spare PCG outputs, so the lens costs no second path.

    python -m spira_tpu_torch.examples.dof_render [out.png]
"""

from __future__ import annotations

import sys

import spira_tpu_torch as sp


def scene_and_camera(aspect: float, device="cuda"):
    camera = sp.make_camera(
        lookfrom=(0.0, 1.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vfov=60.0,
        aspect_ratio=aspect,
        aperture=0.35,  # wide aperture: strong defocus blur
        focus_dist=3.2,  # focal plane on the center sphere
        device=device,
    )
    return sp.create_scene(device=device), camera


def run(out: str | None = "dof_render.png", *, width: int = 640,
        height: int = 360, spp: int = 64, max_depth: int = 4, seed: int = 0,
        device="cuda"):
    """Render the demo through the lens and write it to ``out``; returns
    the (H, W, 3) uint8 image."""
    scene, camera = scene_and_camera(width / height, device)
    return sp.render(scene, camera, width, height, samples_per_pixel=spp,
                     max_depth=max_depth, seed=seed, output_path=out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "dof_render.png"
    img = run(out)
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")


if __name__ == "__main__":
    main()
