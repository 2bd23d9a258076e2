"""Basic render of the default demo scene: the twin of
``examples/basic_render.py`` (640x360, spp 16, depth 4).

    python -m spira_tpu_torch.examples.basic_render [out.png]
"""

from __future__ import annotations

import sys

import spira_tpu_torch as sp


def scene_and_camera(aspect: float, device="cuda"):
    return sp.create_scene(device=device), sp.default_camera(aspect,
                                                             device=device)


def run(out: str | None = "basic_render.png", *, width: int = 640,
        height: int = 360, spp: int = 16, max_depth: int = 4, seed: int = 0,
        device="cuda"):
    """Render the demo and write it to ``out`` (a PNG); returns the
    (H, W, 3) uint8 image."""
    scene, camera = scene_and_camera(width / height, device)
    return sp.render(scene, camera, width, height, samples_per_pixel=spp,
                     max_depth=max_depth, seed=seed, output_path=out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "basic_render.png"
    img = run(out)
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")


if __name__ == "__main__":
    main()
