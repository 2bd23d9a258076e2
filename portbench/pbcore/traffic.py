"""What every kind of traffic shares.  A traffic mix is a data file,
``traffic/<name>.json``, whose ``kind`` names the generator that reads it:
``kinds/<kind>.py`` (``frames``: final frames; ``steps``: an
inverse-rendering loop), found by that name.  Every call draws a fresh
sampling seed from the run's seed and its index."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

from .cells import derive_seed


def resolve(path: str):
    """``"render.render_flat_hybrid_grad_mesh"`` → the function of
    ``spira_tpu_torch.render`` of that name."""
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module("spira_tpu_torch." + module), name)


@dataclass
class Call:
    """One call of the window: its latency and whether it failed."""

    index: int
    seconds: float
    ok: bool
    error: str = ""


def edge_pixels(width: int, height: int) -> np.ndarray:
    """The bottom-up flat indices of a frame's first and last row and
    column: every edge tile, and the last pixels of the flat order."""
    rows = np.arange(height)
    return np.unique(np.concatenate([
        np.arange(width), (height - 1) * width + np.arange(width),
        rows * width, rows * width + width - 1]))


def check_pixels(mix, seed):
    """The bottom-up flat indices, sorted, of the pixels a frames run
    checks: ``check_pixels`` of them drawn from the run's seed, and with
    ``check_edges`` the frame's edges (:func:`edge_pixels`) besides."""
    w, h = mix["width"], mix["height"]
    rng = np.random.default_rng(derive_seed(seed, "pixels"))
    picked = rng.choice(w * h, size=min(mix["check_pixels"], w * h),
                        replace=False)
    if mix.get("check_edges"):
        picked = np.concatenate([picked, edge_pixels(w, h)])
    return np.unique(picked)
