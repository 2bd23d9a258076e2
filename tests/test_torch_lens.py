"""The wavefront's thin lens against JAX's on a camera built as a pinhole.

JAX's ``_rays_from_uv`` draws the lens disk and adds ``lens_radius * r *
(cos phi * u + sin phi * v)`` whatever the camera's static ``has_lens``
says (``spira_tpu/scene/camera.py``), so a camera built with aperture 0
whose ``lens_radius`` is later raised (say by an optimizer) renders a
thin lens, and at a pinhole ``lens_radius`` takes a gradient.  The port
must do the same.

Tolerances: rays within 1e-6 absolute, as ``test_torch_rng.py`` holds
raygen (float32 rounding of the same formulas); the gradient within 1e-4
relative / 1e-5 absolute (a sum over all rays of float32 products, in
another order on each side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.core import rng as jr
from spira_tpu.scene.camera import generate_rays as j_generate_rays
from spira_tpu_torch.core import rng as tr

torch.set_num_threads(1)

DIR_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
W, H = 16, 8


def _cameras():
    """The same pinhole-built camera in both packages."""
    jcam = st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=W / H)
    cam = sp.camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam),
                               device="cpu")
    assert not jcam.has_lens and not cam.has_lens
    return jcam, cam


def _keys(seed):
    return (jax.random.fold_in(jr.sample_key(jr.base_key(seed), 2), 0),
            tr.fold_in(tr.sample_key(tr.base_key(seed), 2), 0))


@pytest.mark.parametrize("radius", [0.05, 0.3])
def test_raised_lens_radius_matches_jax(radius):
    """A pinhole-built camera with ``lens_radius`` replaced: the port's
    rays are JAX's, thin-lens origins included."""
    jcam, cam = _cameras()
    jcam = dataclasses.replace(jcam, lens_radius=jnp.float32(radius))
    cam = dataclasses.replace(cam, lens_radius=torch.tensor(radius))
    jk, tk = _keys(5)
    jo, jd = j_generate_rays(jcam, W, H, jk)
    to, td = sp.generate_rays(cam, W, H, tk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=DIR_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DIR_ATOL)
    spread = np.linalg.norm(np.asarray(jo) - np.asarray(jcam.origin), axis=1)
    assert 0.0 < spread.max() <= radius * (1 + 1e-6)


def test_lens_radius_gradient_at_a_pinhole_matches_jax():
    """The gradient of a fixed linear loss of the rays with respect to
    ``lens_radius`` at 0: JAX's, and not absent."""
    jcam, cam = _cameras()
    jk, tk = _keys(9)
    rng = np.random.default_rng(3)
    wo = rng.normal(size=(W * H, 3)).astype(np.float32)
    wd = rng.normal(size=(W * H, 3)).astype(np.float32)

    def j_loss(radius):
        o, d = j_generate_rays(dataclasses.replace(jcam, lens_radius=radius),
                               W, H, jk)
        return jnp.sum(o * wo) + jnp.sum(d * wd)

    want = float(jax.grad(j_loss)(jnp.float32(0.0)))
    radius = torch.zeros((), requires_grad=True)
    o, d = sp.generate_rays(dataclasses.replace(cam, lens_radius=radius),
                            W, H, tk)
    ((o * torch.from_numpy(wo)).sum()
     + (d * torch.from_numpy(wd)).sum()).backward()
    assert radius.grad is not None
    assert abs(want) > 1e-3
    np.testing.assert_allclose(float(radius.grad), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    # the pinhole's rays are unchanged by the draw
    o0, d0 = sp.generate_rays(cam, W, H, tk)
    jo, jd = j_generate_rays(jcam, W, H, jk)
    assert torch.equal(o0, cam.origin.expand_as(o0))
    np.testing.assert_allclose(d0.numpy(), np.asarray(jd), atol=DIR_ATOL)
