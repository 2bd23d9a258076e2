"""Geometry primitives as structures of tensors: spheres and triangle soups.

Counterpart of :mod:`spira_tpu.scene.geometry`.  Each primitive kind is one
SoA dataclass over all its instances.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import tensor_dataclass


@tensor_dataclass
class Spheres:
    """SoA over S spheres: centers (S,3), radii (S,), material (S,) int32."""

    centers: torch.Tensor
    radii: torch.Tensor
    material: torch.Tensor

    @property
    def count(self) -> int:
        return self.centers.shape[0]


def make_spheres(records, device=None) -> Spheres:
    """records: list of (center, radius, material_index), 0-based indices;
    on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return Spheres(
        centers=torch.tensor(
            [r[0] for r in records], dtype=torch.float32, device=device
        ),
        radii=torch.tensor(
            [r[1] for r in records], dtype=torch.float32, device=device
        ),
        material=torch.tensor(
            [r[2] for r in records], dtype=torch.int32, device=device
        ),
    )


def empty_spheres(device=None) -> Spheres:
    device = resolve_device(device)
    return Spheres(
        centers=torch.zeros((0, 3), dtype=torch.float32, device=device),
        radii=torch.zeros((0,), dtype=torch.float32, device=device),
        material=torch.zeros((0,), dtype=torch.int32, device=device),
    )


@tensor_dataclass
class Triangles:
    """SoA over T triangles.

    v0:       (T, 3) first vertex
    e1, e2:   (T, 3) edge vectors v1-v0, v2-v0 (for Möller–Trumbore)
    normal:   (T, 3) unit geometric normal
    material: (T,)   int32 material index
    """

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    material: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def make_triangles(vertices, faces, material, device=None) -> Triangles:
    """Build a Triangles SoA from (V,3) vertices and (T,3) int faces.

    ``material`` is a scalar or a (T,) array of material indices.  The
    edges and normals are computed in numpy, as the JAX package does, so
    both packages hold the same values.  The tensors go to ``device``
    (``None``: the card).
    """
    device = resolve_device(device)
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    mat = np.broadcast_to(np.asarray(material, np.int32), (faces.shape[0],))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Triangles(v0=t(v0), e1=t(e1), e2=t(e2), normal=t(n),
                     material=t(mat))


def empty_triangles(device=None) -> Triangles:
    device = resolve_device(device)
    z = torch.zeros((0, 3), dtype=torch.float32, device=device)
    return Triangles(
        v0=z, e1=z, e2=z, normal=z,
        material=torch.zeros((0,), dtype=torch.int32, device=device),
    )


def concat_triangles(parts) -> Triangles:
    """The parts' triangles in order, on their device (no parts: an empty
    host table)."""
    parts = [p for p in parts if p.count > 0]
    if not parts:
        return empty_triangles("cpu")
    return Triangles(
        v0=torch.cat([p.v0 for p in parts]),
        e1=torch.cat([p.e1 for p in parts]),
        e2=torch.cat([p.e2 for p in parts]),
        normal=torch.cat([p.normal for p in parts]),
        material=torch.cat([p.material for p in parts]),
    )


def triangle_bounds(tris: Triangles):
    """Per-triangle AABBs (lo, hi), both (T, 3) numpy float32, for the
    host-side BVH builders."""
    v0 = tris.v0.detach().cpu().numpy()
    v1 = v0 + tris.e1.detach().cpu().numpy()
    v2 = v0 + tris.e2.detach().cpu().numpy()
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    return lo, hi
