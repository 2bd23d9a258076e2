"""Batched 3-vector math on ``(..., 3)`` tensors.

Frozen copy of ``spira_tpu_torch/core/vecmath.py`` at commit 86df806,
its constants made in the precision of the tensors they meet.
"""

from __future__ import annotations

import torch

INF = 1e20
SCATTER_EPS = 1e-4
T_MIN = 1e-3


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def length(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a, eps=1e-20):
    return a * torch.reciprocal(torch.clamp(length(a), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(incident, normal):
    return incident - 2.0 * vdot(incident, normal) * normal


def refract(incident, normal, eta):
    cos_i = -vdot(incident, normal)
    sin2_t = (eta ** 2) * torch.clamp(1.0 - cos_i ** 2, min=0.0)
    tir = sin2_t[..., 0] > 1.0
    ok = sin2_t < 1.0
    cos_t = torch.where(ok, torch.sqrt(torch.where(ok, 1.0 - sin2_t, 1.0)),
                        0.0)
    refracted = eta * incident + (eta * cos_i - cos_t) * normal
    return refracted, tir


def orthonormal_basis(w):
    pick_y = torch.abs(w[..., 0:1]) > 0.1
    unit_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    helper = torch.where(pick_y, unit_y, unit_x)
    u = normalize(cross(helper, w))
    v = cross(w, u)
    return u, v


def where(mask, a, b):
    return torch.where(mask[..., None], a, b)
