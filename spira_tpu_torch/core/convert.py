"""Build the port's scene and camera from objects with numpy leaves.

The JAX package's scene and camera are pytrees.  Mapped to numpy (for
example ``jax.tree_util.tree_map(np.asarray, scene)``), their fields are
read here by name, so the port renders exactly the reference's values
(the spectral tables ``albedo_spd`` and ``emission_spd`` included): a
camera rebuilt through ``tan`` and ``deg2rad`` may differ by an ULP between
frameworks.  The BVH tables (``bvh``, a FlatBVH; ``packed``, a PackedBVH;
``wide``, a WideBVH, MXUBVH or SuperleafBVH, told apart by their fields)
come across value-exact with their static fields.  Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.bvh import FlatBVH
from ..accel.mxu import MXUBVH, SuperleafBVH
from ..accel.pairs import PackedBVH
from ..accel.wide import WideBVH
from .device import resolve_device
from ..scene.camera import Camera
from ..scene.geometry import Spheres, Triangles
from ..scene.materials import Materials
from ..scene.scene import Scene


def _t(x, device, dtype=None):
    if x is None:
        return None
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def _bvh(obj, device):
    if obj is None:
        return None
    return FlatBVH(
        node_min=_t(obj.node_min, device, np.float32),
        node_max=_t(obj.node_max, device, np.float32),
        left=_t(obj.left, device, np.int32),
        right=_t(obj.right, device, np.int32),
        is_leaf=_t(obj.is_leaf, device, np.int32),
        prim_idx=_t(obj.prim_idx, device, np.int32),
        parent=_t(obj.parent, device, np.int32),
        sibling=_t(obj.sibling, device, np.int32),
        is_left=_t(obj.is_left, device, np.int32),
        max_leaf=int(obj.max_leaf),
        n_sph=int(obj.n_sph),
    )


def _packed(obj, device):
    if obj is None:
        return None
    return PackedBVH(
        pairs=_t(obj.pairs, device, np.float32),
        tri_rows=_t(obj.tri_rows, device, np.float32),
        prim_map=_t(obj.prim_map, device, np.int32),
        root=int(obj.root),
        n_rows=int(obj.n_rows),
        n_pairs=int(obj.n_pairs),
        max_leaf=int(obj.max_leaf),
        depth=int(obj.depth),
        form=str(obj.form),
        fanout=int(obj.fanout),
    )


def _wide(obj, device):
    if obj is None:
        return None
    f32 = np.float32
    coeffs = {}
    if hasattr(obj, "coeff_uv"):
        coeffs = dict(coeff_uv=_t(obj.coeff_uv, device, f32),
                      coeff_t=_t(obj.coeff_t, device, f32),
                      coeff_pay=_t(obj.coeff_pay, device, f32))
    if hasattr(obj, "pairs"):
        return SuperleafBVH(
            pairs=_t(obj.pairs, device, f32), **coeffs, root=int(obj.root),
            n_pairs=int(obj.n_pairs), n_blocks=int(obj.n_blocks),
            depth=int(obj.depth))
    if coeffs:
        return MXUBVH(
            nodes=_t(obj.nodes, device, f32), **coeffs, root=int(obj.root),
            n_nodes=int(obj.n_nodes), n_leaves=int(obj.n_leaves))
    if not hasattr(obj, "tri_rows"):
        raise ValueError(
            f"scene.wide is a {type(obj).__name__}, not a WideBVH, MXUBVH "
            "or SuperleafBVH")
    return WideBVH(
        nodes=_t(obj.nodes, device, f32),
        tri_rows=_t(obj.tri_rows, device, f32), root=int(obj.root),
        n_nodes=int(obj.n_nodes), n_rows=int(obj.n_rows),
        max_leaf=int(obj.max_leaf))


def scene_from_numpy(obj, device=None) -> Scene:
    """Scene from an object with the JAX Scene's fields as numpy arrays,
    on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    sph, tri, mats = obj.spheres, obj.triangles, obj.materials
    f32 = np.float32
    return Scene(
        spheres=Spheres(
            centers=_t(sph.centers, device, f32),
            radii=_t(sph.radii, device, f32),
            material=_t(sph.material, device, np.int32),
        ),
        triangles=Triangles(
            v0=_t(tri.v0, device, f32),
            e1=_t(tri.e1, device, f32),
            e2=_t(tri.e2, device, f32),
            normal=_t(tri.normal, device, f32),
            material=_t(tri.material, device, np.int32),
        ),
        materials=Materials(
            albedo=_t(mats.albedo, device, f32),
            emission=_t(mats.emission, device, f32),
            metallic=_t(mats.metallic, device, f32),
            roughness=_t(mats.roughness, device, f32),
            ior=_t(mats.ior, device, f32),
            transmission=_t(mats.transmission, device, f32),
            albedo_spd=_t(getattr(mats, "albedo_spd", None), device, f32),
            emission_spd=_t(getattr(mats, "emission_spd", None), device, f32),
            cauchy_b=_t(getattr(mats, "cauchy_b", None), device, f32),
        ),
        bvh=_bvh(getattr(obj, "bvh", None), device),
        packed=_packed(getattr(obj, "packed", None), device),
        wide=_wide(getattr(obj, "wide", None), device),
    )


def camera_from_numpy(obj, device=None) -> Camera:
    """Camera from an object with the JAX Camera's fields as numpy arrays,
    on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    f32 = np.float32
    return Camera(
        origin=_t(obj.origin, device, f32),
        lower_left_corner=_t(obj.lower_left_corner, device, f32),
        horizontal=_t(obj.horizontal, device, f32),
        vertical=_t(obj.vertical, device, f32),
        u=_t(obj.u, device, f32),
        v=_t(obj.v, device, f32),
        lens_radius=_t(obj.lens_radius, device, f32),
        has_lens=bool(obj.has_lens),
    )
