"""Triangle meshes that the configurations name, made on the host.

Frozen copies, at commit 86df806, of ``spira_tpu_torch/scene/obj.py:
icosphere_mesh``, ``spira_tpu_torch/scene/bunny.py:_part`` and of the
edge and normal arithmetic of ``spira_tpu_torch/scene/geometry.py:
make_triangles``; the generators themselves are ``meshes/<name>.py``.
The benchmark makes these arrays once and hands the same ones to the
program and to the reference.
"""

from __future__ import annotations

import numpy as np


def icosphere_mesh(subdivisions=2):
    """Unit icosphere: (verts (V, 3) float64, faces (T, 3) int64)."""
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


def part(subdivisions, scale3, rotate_deg, translate, squash=None):
    """Deformed icosphere: per-axis scale, optional taper along +y,
    Euler Y/Z/X rotation, translation.  Returns (verts float32, faces)."""
    verts, faces = icosphere_mesh(subdivisions)
    v = verts * np.asarray(scale3, np.float64)
    if squash is not None:
        y = v[:, 1]
        t = (y - y.min()) / max(y.max() - y.min(), 1e-9)
        s = 1.0 + (squash - 1.0) * t
        v[:, 0] *= s
        v[:, 2] *= s
    rx, ry, rz = [np.deg2rad(a) for a in rotate_deg]
    for axis, ang in ((0, rx), (1, ry), (2, rz)):
        if ang:
            c, s = np.cos(ang), np.sin(ang)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            vi, vj = v[:, i].copy(), v[:, j].copy()
            v[:, i] = c * vi - s * vj
            v[:, j] = s * vi + c * vj
    v += np.asarray(translate, np.float64)
    return v.astype(np.float32), faces


def make_parts(spec):
    """The parts of a configuration's ``mesh`` entry: a list of (verts
    float32 (V, 3), faces int64 (T, 3)), or [] for none.  The entry's
    ``generator`` names the module ``pbref/meshes/<generator>.py``, whose
    ``make`` takes the entry's other keys but ``material``."""
    if not spec:
        return []
    from . import plugin

    kw = {k: v for k, v in spec.items() if k not in ("generator",
                                                      "material")}
    return plugin("meshes", spec["generator"]).make(**kw)


def triangle_arrays(parts, material):
    """v0, e1, e2, unit normal (each (T, 3) float32) and material (T,)
    int32 of the concatenated parts, as ``make_triangles`` computes them."""
    out = {k: [] for k in ("v0", "e1", "e2", "normal")}
    for verts, faces in parts:
        v0 = verts[faces[:, 0]]
        e1 = verts[faces[:, 1]] - v0
        e2 = verts[faces[:, 2]] - v0
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        for k, a in zip(out, (v0, e1, e2, n)):
            out[k].append(a.astype(np.float32))
    tris = {k: (np.concatenate(v) if v else np.zeros((0, 3), np.float32))
            for k, v in out.items()}
    tris["material"] = np.full(tris["v0"].shape[0], material, np.int32)
    return tris
