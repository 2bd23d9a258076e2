"""Adaptive progressive render: the twin of ``examples/adaptive_render.py``.
Rows retire once the 98th percentile of their pixels' relative luminance
half-CI95 drops below ``tol``; each round renders only the surviving
rows.  Prints the per-row spp histogram and the samples saved against a
uniform render at the spp cap (640x360, cap 64, at least 8).

    python -m spira_tpu_torch.examples.adaptive_render [out.png] [tol]
"""

from __future__ import annotations

import sys

import torch

import spira_tpu_torch as sp
from spira_tpu_torch.io import image as img_io
from spira_tpu_torch.pipeline import render_adaptive
from spira_tpu_torch.utils.config import RenderConfig


def run(out: str | None = "adaptive.png", tol: float = 0.05, *,
        width: int = 640, height: int = 360, spp: int = 64,
        min_spp: int = 8, chunk: int = 8, max_depth: int = 4, seed: int = 0,
        device="cuda"):
    """Render the demo adaptively by row and write it to ``out``;
    returns the (H, W, 3) HDR image and the renderer's stats."""
    scene = sp.create_scene(device=device)
    camera = sp.default_camera(width / height, device=device)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, seed=seed, progress=False,
                       device=str(device))
    img, stats = render_adaptive(scene, camera, cfg, tol=tol,
                                 min_spp=min_spp, chunk=chunk,
                                 return_stats=True)
    if out is not None:
        img_io.save_png(out, img_io.to_uint8(img_io.tonemap_gamma(
            torch.from_numpy(img.copy()))))
    return img, stats


def histogram(spp_per_row, cap: int) -> list:
    """Lines of the rows' spp histogram in bins of 8 samples."""
    lines = []
    for lo in range(0, cap, 8):
        n = int(((spp_per_row > lo) & (spp_per_row <= lo + 8)).sum())
        lines.append(f"  spp {lo + 1:3d}-{lo + 8:3d}: {'#' * (n // 4)} "
                     f"{n} rows")
    return lines


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "adaptive.png"
    tol = float(argv[1]) if len(argv) > 1 else 0.05
    cap = 64
    _, stats = run(out, tol, spp=cap)
    print(f"wrote {out}; saved {100 * stats['savings']:.1f}% of samples "
          f"(cap {cap} spp)")
    print("\n".join(histogram(stats["spp_per_row"], cap)))


if __name__ == "__main__":
    main()
