"""The spectral mesh render (``render_flat_hybrid_grad_mesh(spectral=True)``)
on the CPU: the counterparts of JAX's ``tests/test_grad.py:584`` and
``:638`` on JAX's budget mesh (the subdivision-0 icosphere, its BVH at
leaf size 4, 48x8, spp 1, depth 2, seed 3).

* The forward with ``engine="cuda_bvh"`` is the spectral packed-BVH path
  tracer (#5; its plain version here), to the bit.
* Under a linear loss the gradient to ``albedo_spd`` through the packet
  backward equals the spectral wavefront replay's (autograd through
  ``render_flat``), within JAX's atol 1e-8 / rtol 1e-5.
* It matches ``jax.grad`` of JAX's spectral ``render_flat`` on the same
  scene, within ``tests/test_torch_grad.py``'s tolerance (rtol 1e-3 plus
  1e-4 of the largest magnitude).
* A central difference of the dominant SPD bin, with JAX's step and
  bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import spira_tpu_torch as sp
from spira_tpu.core.types import replace as jreplace
from spira_tpu.render import render_flat as j_render_flat
from spira_tpu_torch.kernels import spectral_bvh as tsb

from .test_torch_grad import GRAD_ATOL_SHARE, GRAD_RTOL
from .test_torch_mesh_grad import MESH_KW, budget_mesh  # noqa: F401

torch.set_num_threads(1)


def _with_spd(scene, spd):
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo_spd=spd))


def _spd_grad(render, scene, cam, loss_fn=torch.mean):
    spd = scene.materials.albedo_spd.clone().requires_grad_()
    loss_fn(render(_with_spd(scene, spd), cam)).backward()
    return spd.grad.numpy()


def _hybrid(**kw):
    return lambda scene, cam: sp.render_flat_hybrid_grad_mesh(
        scene, cam, spectral=True, **MESH_KW, **kw)


def test_spectral_forward_is_the_spectral_bvh_kernel(budget_mesh):
    _, _, scene, cam = budget_mesh
    got = _hybrid(engine="cuda_bvh", bwd="packet")(scene, cam)
    want = tsb.render_flat_spectral_bvh_megakernel(scene, cam, **MESH_KW)
    assert torch.equal(got, want) and want.std() > 0


def test_spd_gradient_matches_the_replay_and_jax(budget_mesh):
    jscene, jcam, scene, cam = budget_mesh
    got = _spd_grad(_hybrid(engine="cuda_bvh", bwd="packet"), scene, cam)
    replay = _spd_grad(lambda s, c: sp.render_flat(s, c, spectral=True,
                                                   **MESH_KW), scene, cam)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, replay, atol=1e-8, rtol=1e-5)

    def loss(spd):
        sc = jreplace(jscene, materials=jreplace(jscene.materials,
                                                 albedo_spd=spd))
        return jnp.mean(j_render_flat(sc, jcam, spectral=True, **MESH_KW))

    want = np.asarray(jax.jit(jax.grad(loss))(jscene.materials.albedo_spd))
    ok = np.isfinite(want)
    atol = GRAD_ATOL_SHARE * float(np.abs(want[ok]).max())
    np.testing.assert_allclose(got[ok], want[ok], rtol=GRAD_RTOL, atol=atol)


def test_spd_gradient_matches_central_differences(budget_mesh):
    """mean(img ** 2) with the wavefront forward, so the loss is the
    backward's estimator; the dominant bin at eps 2e-3 (JAX's bound)."""
    _, _, scene, cam = budget_mesh
    render = _hybrid(engine="wavefront", bwd="packet")
    g = _spd_grad(render, scene, cam, loss_fn=lambda img: (img ** 2).mean())
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    i, j = np.unravel_index(np.abs(g).argmax(), g.shape)
    s64 = scene.materials.albedo_spd.double()
    eps = 2e-3
    probes = []
    for sign in (1, -1):
        p = s64.clone()
        p[i, j] += sign * eps
        with torch.no_grad():
            img = render(_with_spd(scene, p.float()), cam)
        probes.append(float((img ** 2).mean()))
    fd = (probes[0] - probes[1]) / (2 * eps)
    assert abs(fd - g[i, j]) <= max(2e-3, 0.05 * abs(fd)), (fd, g[i, j])
