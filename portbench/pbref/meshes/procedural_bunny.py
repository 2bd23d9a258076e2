"""``procedural_bunny``: the port's 72,960-triangle procedural stand-in
for the Stanford bunny, nine deformed icospheres.  A frozen copy, at
commit 86df806, of ``spira_tpu_torch/scene/bunny.py:procedural_bunny``;
the geometry is made up, not the scanned mesh (69,451 triangles)."""

from pbref.mesh import part


def make(scale: float = 1.0):
    """The stand-in bunny's nine parts, each (verts float32, faces)."""
    s = scale
    return [
        part(5, (0.52 * s, 0.42 * s, 0.62 * s), (8, 0, 0),
             (0.0, 0.38 * s, 0.0)),
        part(5, (0.26 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
             (0.0, 0.78 * s, 0.48 * s)),
        part(4, (0.09 * s, 0.34 * s, 0.13 * s), (18, 0, 12),
             (-0.14 * s, 1.18 * s, 0.38 * s), squash=0.55),
        part(4, (0.09 * s, 0.34 * s, 0.13 * s), (18, 0, -12),
             (0.14 * s, 1.18 * s, 0.38 * s), squash=0.55),
        part(4, (0.2 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
             (-0.38 * s, 0.22 * s, -0.3 * s)),
        part(4, (0.2 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
             (0.38 * s, 0.22 * s, -0.3 * s)),
        part(4, (0.11 * s, 0.1 * s, 0.26 * s), (0, 0, 0),
             (-0.2 * s, 0.06 * s, 0.42 * s)),
        part(4, (0.11 * s, 0.1 * s, 0.26 * s), (0, 0, 0),
             (0.2 * s, 0.06 * s, 0.42 * s)),
        part(3, (0.11 * s, 0.11 * s, 0.11 * s), (0, 0, 0),
             (0.0, 0.34 * s, -0.66 * s)),
    ]
