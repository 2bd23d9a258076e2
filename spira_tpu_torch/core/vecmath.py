"""The 3-vector helpers and constants the scene model needs.

Counterparts of :mod:`spira_tpu.core.vecmath` on ``(..., 3)`` tensors.  The
rest of that module serves the wavefront estimator, a later slice.
"""

from __future__ import annotations

import torch

INF = 1e20
# Scatter-origin offset and minimum hit distance, as in the JAX package.
SCATTER_EPS = 1e-4
T_MIN = 1e-3


def length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a, eps=1e-20):
    """Safe normalize: returns a / |a| with a tiny floor to avoid 0/0."""
    return a * torch.reciprocal(torch.clamp(length(a), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)
