"""The port's differentiable step against JAX's on a scene with triangles,
past the depth where Russian roulette starts: the demo scene plus a
2-triangle back wall at depth 5, every gradient field (triangle ``v0``,
``e1``, ``e2`` and ``normal`` included).  Cases and tolerances as in
``tests/test_torch_grad.py``; this case's JAX compile takes minutes, so
it has a file of its own for the test workers to spread.
"""

import numpy as np

from tests.test_torch_grad import RR_CASE, check_against_jax


def test_hybrid_grad_matches_jax_with_triangles_and_roulette():
    got = check_against_jax("quad_rr", RR_CASE)
    for field in ("v0", "e1", "e2", "normal"):
        assert np.abs(got[field]).max() > 0, field
