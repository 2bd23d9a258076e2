"""The port's ``render_mse_loss_and_grads`` on the CPU (its plain version:
the forward through the plain tracer, gradients by autograd through it)
against JAX's ``render_mse_loss_and_grads`` (the Pallas grad kernel, run
in interpret mode), at ``tests/test_grad_megakernel.py``'s setup; and the
entry point's refusals.

Tolerances: the loss within 1e-5 relative; each gradient field within
rtol 1e-3 plus an atol of 1e-4 of that field's largest magnitude (1e-3
for the sphere centres and radii), on every entry where the reference is
finite (its camera gradients are NaN where a grazing lane meets sqrt(0);
ROADMAP queue 3).  Measured: the loss to 1e-7 relative; at grad_spp=1 one
sphere-centre entry 1.5e-4 of its field's largest magnitude beyond rtol
1e-3 (a small entry where the centre terms of many paths cancel, so the
last bits in which XLA and torch differ show), the materials under 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu.kernels.grad_megakernel import (
    render_mse_loss_and_grads as jax_loss_and_grads,
)
from spira_tpu.kernels.megakernel import render_flat_fused as jax_fused
from spira_tpu.scene.camera import make_camera as jax_make_camera
from spira_tpu.scene.scene import create_scene as jax_create_scene
from spira_tpu_torch.kernels import grad_megakernel as tgk
from spira_tpu_torch.scene.geometry import empty_spheres

torch.set_num_threads(1)

W, H, SPP, DEPTH, SEED = 128, 8, 2, 3, 11
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-4
GEOMETRY_ATOL_SHARE = 1e-3
SCENE_FIELDS = {
    "spheres": ("centers", "radii"),
    "materials": ("albedo", "emission", "metallic", "roughness", "ior",
                  "transmission"),
}
CAMERA_FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical",
                 "u", "v", "lens_radius")


def _setup():
    scene = jax_create_scene()
    cam = jax_make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          aspect_ratio=W / H)
    # a slightly perturbed render, so that the residuals are not trivial
    target = jax_fused(scene, cam, width=W, height=H, spp=SPP,
                       max_depth=DEPTH, seed=99)
    return scene, cam, np.asarray(target) * np.float32(0.9)


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _compare(field, got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), field
    ok = np.isfinite(want)
    if not ok.any():
        return 0
    share = (GEOMETRY_ATOL_SHARE if field in SCENE_FIELDS["spheres"]
             else GRAD_ATOL_SHARE)
    atol = share * float(np.abs(want[ok]).max())
    np.testing.assert_allclose(got[ok], want[ok], rtol=GRAD_RTOL, atol=atol,
                               err_msg=field)
    return 1


@pytest.mark.parametrize("grad_spp", [None, 1])
def test_loss_and_grads_match_jax_kernel(grad_spp):
    jscene, jcam, target = _setup()
    kw = dict(width=W, height=H, spp=SPP, grad_spp=grad_spp, max_depth=DEPTH,
              seed=SEED)
    want_loss, want_scene, want_cam = jax_loss_and_grads(
        jscene, jcam, jnp.asarray(target), interpret=True, **kw)
    scene, cam = _port(jscene, jcam)
    loss, d_scene, d_cam = sp.render_mse_loss_and_grads(scene, cam, target,
                                                        **kw)
    assert loss.dtype == torch.float32
    assert abs(float(loss) / float(want_loss) - 1.0) <= LOSS_RTOL
    compared = 0
    for group, fields in SCENE_FIELDS.items():
        for field in fields:
            want = getattr(getattr(want_scene, group), field)
            assert np.isfinite(np.asarray(want)).all(), field
            compared += _compare(field, getattr(getattr(d_scene, group),
                                                field), want)
    for field in CAMERA_FIELDS:
        compared += _compare(field, getattr(d_cam, field),
                             getattr(want_cam, field))
    assert compared >= len(SCENE_FIELDS["materials"]) + 2
    # gradients reach the visible materials and the sphere geometry
    assert d_scene.materials.albedo[:2].abs().min() > 0
    assert d_scene.spheres.centers.abs().max() > 0


def test_cotangents_have_the_scene_types():
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(4.0, device="cpu")
    target = torch.full((32 * 8, 3), 0.3)
    kw = dict(width=32, height=8, spp=2, max_depth=2, seed=1)
    loss, d_scene, d_cam = sp.render_mse_loss_and_grads(scene, cam, target,
                                                        **kw)
    assert isinstance(d_scene, sp.Scene) and isinstance(d_cam, sp.Camera)
    assert d_scene.spheres.material is None and d_scene.bvh is None
    assert d_scene.packed is None and d_cam.has_lens is None
    assert d_scene.triangles.v0.shape == (0, 3)
    # fields no gradient reaches hold zeros
    assert d_scene.materials.transmission.abs().max() == 0
    assert d_cam.u.abs().max() == 0 and d_cam.lens_radius == 0
    spd = scene.materials.albedo_spd
    assert d_scene.materials.albedo_spd.shape == spd.shape
    plain = tgk.render_mse_loss_and_grads_plain(scene, cam, target, **kw)
    assert torch.equal(loss, plain[0])
    assert torch.equal(d_scene.materials.albedo, plain[1].materials.albedo)
    assert torch.equal(d_cam.origin, plain[2].origin)


def _spheres(n):
    if n == 0:
        return empty_spheres("cpu")
    return sp.make_spheres([((0.3 * i, 0.0, -2.0), 0.1, 0) for i in range(n)],
                           device="cpu")


@pytest.mark.parametrize("what", ["no spheres", "17 spheres", "triangles",
                                  "thin lens"])
def test_refuses_what_the_kernel_does_not_take(what):
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    if what == "no spheres":
        scene = dataclasses.replace(scene, spheres=_spheres(0))
    elif what == "17 spheres":
        scene = dataclasses.replace(scene, spheres=_spheres(17))
    elif what == "triangles":
        verts = np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32)
        scene = dataclasses.replace(
            scene, triangles=sp.make_triangles(verts, np.array([[0, 1, 2]]),
                                               0, device="cpu"))
    else:
        # the reference reads 12 camera fields and would trace this lens
        # camera as a pinhole, with no error
        cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                             aspect_ratio=2.0, aperture=0.2, focus_dist=3.0,
                             device="cpu")
    target = torch.zeros(16 * 8, 3)
    for fn in (sp.render_mse_loss_and_grads,
               tgk.render_mse_loss_and_grads_plain):
        with pytest.raises(ValueError, match="spheres|sphere-only|pinhole"):
            fn(scene, cam, target, width=16, height=8, spp=1, max_depth=1)
