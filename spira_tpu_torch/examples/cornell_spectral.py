"""Spectral Cornell box: the twin of ``examples/cornell_spectral.py``,
hero-wavelength transport, an emissive area light, mirror and dispersive
glass spheres; 512x512, depth 6, ACES tone map.

    python -m spira_tpu_torch.examples.cornell_spectral [out.png] [spp]
"""

from __future__ import annotations

import sys

import spira_tpu_torch as sp


def scene_and_camera(aspect: float, device="cuda"):
    return (sp.create_cornell_box(device=device),
            sp.cornell_camera(aspect, device=device))


def run(out: str | None = "cornell.png", spp: int = 128, *,
        width: int = 512, height: int = 512, max_depth: int = 6,
        seed: int = 0, device="cuda"):
    """Render the box spectrally and write it to ``out``; returns the
    (H, W, 3) uint8 image."""
    scene, camera = scene_and_camera(width / height, device)
    return sp.render(scene, camera, width, height, samples_per_pixel=spp,
                     max_depth=max_depth, seed=seed, spectral=True,
                     tonemap="aces", output_path=out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "cornell.png"
    spp = int(argv[1]) if len(argv) > 1 else 128
    run(out, spp)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
