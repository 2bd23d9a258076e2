"""OBJ loading, mesh transforms, and procedural mesh generators.

Counterpart of :mod:`spira_tpu.scene.obj`: the OBJ parser with fan
triangulation, the center/normalize/scale/rotate/translate pipeline, and the
icosphere and cube generators.  All host-side numpy, as in the JAX package;
the results feed :func:`make_triangles`, which puts them on ``device``.
These build host tables for the BVH builders, so their ``device`` is the
CPU unless the caller names another.
"""

from __future__ import annotations

import numpy as np

from .geometry import Triangles, make_triangles


def parse_obj(text: str, use_native: bool = True):
    """Parse OBJ ``v``/``f`` records; n-gons fan-triangulated.  Returns
    (vertices (V,3) f32, faces (T,3) int64, 0-based).

    Routes through the C++ parser (``native/obj_loader.cpp``) when the
    shared library is available; this Python loop is the fallback."""
    if use_native:
        from ..accel.native import parse_obj_native

        out = parse_obj_native(text)
        if out is not None:
            return out
    verts = []
    faces = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                # tokens may be v, v/vt, v/vt/vn, v//vn
                i = int(tok.split("/")[0])
                # negative indices are relative to the current vertex count
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError("OBJ contains no triangles")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def load_obj(path: str):
    with open(path) as f:
        return parse_obj(f.read())


def transform_vertices(
    vertices: np.ndarray,
    *,
    center: bool = True,
    normalize: bool = True,
    scale=1.0,
    rotate_xyz=(0.0, 0.0, 0.0),
    translate=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """center → unit-normalize → scale → Euler XYZ rotate → translate."""
    v = np.asarray(vertices, np.float64).copy()
    if center:
        v -= v.mean(axis=0)
    if normalize:
        r = np.linalg.norm(v, axis=1).max()
        if r > 0:
            v /= r
    v *= np.asarray(scale, np.float64)
    rx, ry, rz = [np.deg2rad(a) for a in rotate_xyz]
    if rx:
        c, s = np.cos(rx), np.sin(rx)
        v = v @ np.asarray([[1, 0, 0], [0, c, s], [0, -s, c]])
    if ry:
        c, s = np.cos(ry), np.sin(ry)
        v = v @ np.asarray([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    if rz:
        c, s = np.cos(rz), np.sin(rz)
        v = v @ np.asarray([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    v += np.asarray(translate, np.float64)
    return v.astype(np.float32)


def load_obj_mesh(path: str, material: int = 0, device="cpu",
                  **transform_kw) -> Triangles:
    """An OBJ mesh, transformed, as a host table (on the CPU unless
    ``device`` names another)."""
    verts, faces = load_obj(path)
    verts = transform_vertices(verts, **transform_kw)
    return make_triangles(verts, faces, material, device=device)


def icosphere_mesh(subdivisions=2):
    """Unit icosphere as raw arrays: (verts (V,3) f64 on the unit sphere,
    faces (T,3) int64).  20 * 4^subdivisions triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            m /= np.linalg.norm(m)
            verts.append(tuple(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [
                (a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)
            ]
        faces = new_faces

    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def icosphere(
    center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=2, material: int = 0,
    device="cpu",
) -> Triangles:
    """Subdivided icosahedron, as a host table (on the CPU unless
    ``device`` names another)."""
    verts, faces = icosphere_mesh(subdivisions)
    v = verts * radius + np.asarray(center, np.float64)
    return make_triangles(v.astype(np.float32), faces, material,
                          device=device)


def cube(center=(0.0, 0.0, 0.0), size=1.0, material: int = 0,
         device="cpu") -> Triangles:
    """Axis-aligned cube of edge ``size`` — 12 triangles, as a host table
    (on the CPU unless ``device`` names another)."""
    h = size / 2.0
    c = np.asarray(center, np.float64)
    corners = np.asarray(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ]
    ) + c
    quads = [
        (0, 3, 2, 1), (4, 5, 6, 7),  # -z, +z
        (0, 1, 5, 4), (2, 3, 7, 6),  # -y, +y
        (0, 4, 7, 3), (1, 2, 6, 5),  # -x, +x
    ]
    faces = []
    for a, b, cc, d in quads:
        faces += [(a, b, cc), (a, cc, d)]
    return make_triangles(
        corners.astype(np.float32), np.asarray(faces, np.int64), material,
        device=device,
    )
