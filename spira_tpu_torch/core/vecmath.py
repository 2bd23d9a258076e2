"""Batched 3-vector math on ``(..., 3)`` tensors.

Counterparts of :mod:`spira_tpu.core.vecmath`: every helper broadcasts
over a batch prefix, so one call serves a whole wavefront of rays.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import device_constant

INF = 1e20
EPS = 1e-6
# Scatter-origin offset and minimum hit distance, as in the JAX package.
SCATTER_EPS = 1e-4
T_MIN = 1e-3
_UNIT_X = np.asarray([1.0, 0.0, 0.0], np.float32)
_UNIT_Y = np.asarray([0.0, 1.0, 0.0], np.float32)


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    """Batched dot product, keeping the trailing axis for broadcasting."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a, eps=1e-20):
    """Safe normalize: returns a / |a| with a tiny floor to avoid 0/0."""
    return a * torch.reciprocal(torch.clamp(length(a), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(incident, normal):
    """Mirror reflection of ``incident`` about ``normal``."""
    return incident - 2.0 * vdot(incident, normal) * normal


def refract(incident, normal, eta):
    """Snell refraction of a unit ``incident`` about unit ``normal``.

    ``eta`` = n_incident / n_transmitted, (..., 1).  Returns
    (refracted_dir, total_internal_reflection_mask); callers select
    :func:`reflect` where the mask is set.
    """
    cos_i = -vdot(incident, normal)
    sin2_t = (eta ** 2) * torch.clamp(1.0 - cos_i ** 2, min=0.0)
    tir = sin2_t[..., 0] > 1.0
    # double-where: sqrt'(0) = inf at grazing or TIR would poison the
    # backward pass through the masked-off branch
    ok = sin2_t < 1.0
    cos_t = torch.where(ok, torch.sqrt(torch.where(ok, 1.0 - sin2_t, 1.0)),
                        0.0)
    refracted = eta * incident + (eta * cos_i - cos_t) * normal
    return refracted, tir


def orthonormal_basis(w):
    """(u, v) completing unit vector ``w`` to a right-handed frame: the
    helper axis is y where ``|w.x| > 0.1``, else x."""
    pick_y = torch.abs(w[..., 0:1]) > 0.1
    helper = torch.where(pick_y, device_constant("UNIT_Y", _UNIT_Y, w.device),
                         device_constant("UNIT_X", _UNIT_X, w.device))
    u = normalize(cross(helper, w))
    v = cross(w, u)
    return u, v


def where(mask, a, b):
    """Select over vectors with a scalar-per-ray mask of shape batch."""
    return torch.where(mask[..., None], a, b)
