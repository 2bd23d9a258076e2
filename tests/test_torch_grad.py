"""The port's differentiable step (``render_flat_hybrid_grad``) on the CPU:
its loss and every gradient field against JAX's ``render_flat_hybrid_grad``
(whose CPU forward and backward are the fused XLA twin), central
differences, and the per-sample checkpoint.

Inputs come across through the converter, so both sides trace the same
values with the same PCG draws.  Tolerances: the loss within 1e-5
relative; each gradient field within rtol 1e-3 plus an atol of 1e-4 of
that field's largest magnitude.  Measured on these cases and the Russian
roulette case: the loss to 1.5e-7 relative; beyond rtol 1e-3, the worst
entry 2.7e-5 of its field's largest magnitude (sphere radii, where
silhouettes amplify the last bits in which XLA and torch differ), the
material and camera fields under 1e-6.

The reference's gradients are NaN wherever a lane's refraction cosine
lands on sqrt(0) (a grazing ray: ``1 - cos_i**2`` rounds to 1), even on
lanes that do not refract: the camera frame of the demo view, whose
horizon is in sight, gets NaN on most seeds.  The port guards that square
root (ROADMAP queue 3); the comparison runs on every entry where the
reference is finite, the port must be finite everywhere, and the
grad_spp=1 case is a seed on which the reference is finite throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.core.types import replace as jreplace
from spira_tpu.kernels import megakernel as jmk
from spira_tpu.scene.geometry import make_triangles as jax_make_triangles
from spira_tpu_torch.kernels import megakernel as tmk

torch.set_num_threads(1)

W, H = 24, 12
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-4
#: every float leaf the packed tables carry: name -> (group, field)
FIELDS = {
    "albedo": ("materials", "albedo"),
    "emission": ("materials", "emission"),
    "metallic": ("materials", "metallic"),
    "roughness": ("materials", "roughness"),
    "ior": ("materials", "ior"),
    "transmission": ("materials", "transmission"),
    "centers": ("spheres", "centers"),
    "radii": ("spheres", "radii"),
    "v0": ("triangles", "v0"),
    "e1": ("triangles", "e1"),
    "e2": ("triangles", "e2"),
    "normal": ("triangles", "normal"),
    "origin": ("camera", "origin"),
    "lower_left_corner": ("camera", "lower_left_corner"),
    "horizontal": ("camera", "horizontal"),
    "vertical": ("camera", "vertical"),
    "u": ("camera", "u"),
    "v": ("camera", "v"),
    "lens_radius": ("camera", "lens_radius"),
}


def _quad_scene():
    """The demo scene plus a 2-triangle back wall (the triangle loop)."""
    scene = st.create_scene()
    verts = np.array(
        [[-2, -0.5, -1.5], [2, -0.5, -1.5], [2, 1.5, -1.5], [-2, 1.5, -1.5]],
        np.float32,
    )
    quad = jax_make_triangles(verts, np.array([[0, 1, 2], [0, 2, 3]]), 2)
    return dataclasses.replace(scene, triangles=quad)


def _lens_camera():
    return st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=W / H, aperture=0.2, focus_dist=3.0)


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _with(objs, params, rep):
    """(scene, camera) with the FIELDS taken from ``params``."""
    scene, cam = objs
    groups = {g: getattr(scene, g) for g in ("materials", "spheres",
                                             "triangles")}
    groups["camera"] = cam
    for name, (group, field) in FIELDS.items():
        groups[group] = rep(groups[group], **{field: params[name]})
    cam = groups.pop("camera")
    return rep(scene, **groups), cam


def _params(scene, cam):
    objs = {"materials": scene.materials, "spheres": scene.spheres,
            "triangles": scene.triangles, "camera": cam}
    return {n: getattr(objs[g], f) for n, (g, f) in FIELDS.items()}


def _target(n):
    return np.random.default_rng(0).uniform(0.0, 1.0, (n, 3)).astype(
        np.float32)


def _jax_step(jscene, jcam, target, kw):
    def loss(params):
        sc, cm = _with((jscene, jcam), params, jreplace)
        img = jmk.render_flat_hybrid_grad(sc, cm, **kw)
        return jnp.mean((img - target) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(_params(jscene, jcam))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_step(scene, cam, target, kw):
    params = {k: v.detach().clone().requires_grad_()
              for k, v in _params(scene, cam).items()}
    sc, cm = _with((scene, cam), params, dataclasses.replace)
    img = tmk.render_flat_hybrid_grad(sc, cm, **kw)
    loss = ((img - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in params.items()}


CASES = {
    # name: (scene, camera, render kwargs)
    "demo_exact": (st.create_scene, lambda: st.default_camera(W / H),
                   dict(spp=2, max_depth=4, seed=3)),
    # a seed on which the reference's gradients are finite throughout
    "demo_grad_spp1": (st.create_scene, lambda: st.default_camera(W / H),
                       dict(spp=2, grad_spp=1, max_depth=4, seed=1)),
    "thin_lens": (st.create_scene, _lens_camera,
                  dict(spp=2, max_depth=3, seed=2)),
}
#: triangles, and Russian roulette from bounce index 4 (depth 5); its JAX
#: compile takes minutes, so it runs from its own file
#: (tests/test_torch_grad_rr.py) and the test workers spread the two
RR_CASE = (_quad_scene, lambda: st.default_camera(W / H),
           dict(spp=1, max_depth=5, seed=2))


def check_against_jax(name, case):
    build_scene, build_cam, kw = case
    kw = dict(width=W, height=H, **kw)
    jscene, jcam = build_scene(), build_cam()
    target = _target(W * H)
    want_loss, want = _jax_step(jscene, jcam, jnp.asarray(target), kw)
    scene, cam = _port(jscene, jcam)
    got_loss, got = _port_step(scene, cam, target, kw)

    assert abs(got_loss / want_loss - 1.0) <= LOSS_RTOL
    for field in FIELDS:
        g, w = got[field], want[field]
        assert g.shape == w.shape and np.isfinite(g).all(), field
        ok = np.isfinite(w)
        if FIELDS[field][0] != "camera":
            assert ok.all(), f"{field}: the reference is not finite"
        if not ok.any():
            continue
        atol = GRAD_ATOL_SHARE * float(np.abs(w[ok]).max())
        np.testing.assert_allclose(g[ok], w[ok], rtol=GRAD_RTOL, atol=atol,
                                   err_msg=field)
    if name == "demo_grad_spp1":
        assert all(np.isfinite(w).all() for w in want.values())
    # gradients reach the visible materials and the geometry
    assert np.abs(got["albedo"][:2]).min() > 0
    assert np.abs(got["centers"]).max() > 0
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_grad_matches_jax(name):
    check_against_jax(name, CASES[name])


def test_camera_gradients_finite_where_the_reference_is_nan():
    """test_grad.py's view (24x12, spp 2, depth 4, seed 5): the horizon is
    in sight, and a grazing miss lane's untaken refraction used to give
    sqrt'(0) = inf times a zero cotangent, NaN in every camera field."""
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W / H, device="cpu")
    target = _target(W * H)
    _, got = _port_step(scene, cam, target,
                        dict(width=W, height=H, spp=2, max_depth=4, seed=5))
    for field, g in got.items():
        assert np.isfinite(g).all(), field
    assert np.abs(got["origin"]).max() > 0


def _loss_fn(scene, cam, target):
    def loss(albedo, emission):
        mats = dataclasses.replace(scene.materials, albedo=albedo,
                                   emission=emission)
        img = tmk.render_flat_hybrid_grad(
            dataclasses.replace(scene, materials=mats), cam, width=W,
            height=H, spp=2, max_depth=4, seed=5)
        return ((img - target) ** 2).mean()

    return loss


def test_grad_matches_finite_differences():
    """test_grad.py's check on the port: the step is deterministic given the
    seed, so central differences give the directional derivative of the
    same estimator (depth 4 keeps Russian roulette off)."""
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W / H, device="cpu")
    target = torch.full((W * H, 3), 0.25)
    loss = _loss_fn(scene, cam, target)
    albedo = scene.materials.albedo.clone().requires_grad_()
    emission = scene.materials.emission.clone().requires_grad_()
    loss(albedo, emission).backward()
    rs = np.random.default_rng(0)
    eps = 2e-3
    for arr, grad, name in ((scene.materials.albedo, albedo.grad, "albedo"),
                            (scene.materials.emission, emission.grad,
                             "emission")):
        for _ in range(4):
            i, j = int(rs.integers(arr.shape[0])), int(rs.integers(3))
            a64 = arr.double().numpy()
            probes = []
            for sign in (1, -1):
                p = a64.copy()
                p[i, j] += sign * eps
                p = torch.from_numpy(p.astype(np.float32))
                args = ((p, scene.materials.emission) if name == "albedo"
                        else (scene.materials.albedo, p))
                with torch.no_grad():
                    probes.append(float(loss(*args)))
            fd = (probes[0] - probes[1]) / (2 * eps)
            an = float(grad[i, j])
            assert abs(fd - an) <= max(2e-3, 0.06 * abs(fd)), (
                f"{name}[{i},{j}]: fd={fd:.6f} grad={an:.6f}")


def test_remat_gradients_equal_without_remat():
    """The per-sample checkpoint replays each sample's paths in the
    backward pass and changes no gradient bit."""
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W / H, device="cpu")
    kw = dict(width=W, height=H, spp=2, max_depth=4, seed=7)
    cot = torch.from_numpy(_target(W * H))
    grads = []
    for remat in (True, False):
        leaves = [t.detach().requires_grad_()
                  for t in tmk.pack_tables(scene, cam)]
        img = tmk.render_flat_fused(scene, cam, remat=remat, tables=leaves,
                                    **kw)
        grads.append(torch.autograd.grad(img, leaves[:2], cot))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        assert torch.equal(a, b)


def test_sample_offset_shifts_the_sample_index():
    """spp samples from sample_offset k are samples k.. of a longer run."""
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W / H, device="cpu")
    tables = tmk.pack_tables(scene, cam)
    pixel = torch.arange(W * H)
    args = (pixel, (pixel // W).float(), (pixel % W).float(),
            tmk.cam_tuple(tables[0], False),
            [tuple(tables[1][k, f] for f in range(14)) for k in range(5)])
    kw = dict(seed=3, max_depth=3, du=float(W - 1), dv=float(H - 1))
    whole = tmk.trace_tile(*args, spp=3, **kw)
    head = tmk.trace_tile(*args, spp=1, **kw)
    tail = tmk.trace_tile(*args, spp=2, sample_offset=1, **kw)
    for w, a, b in zip(whole, head, tail):
        torch.testing.assert_close(w, a + b, rtol=1e-6, atol=1e-6)


def test_hybrid_forward_is_the_render_and_seed_gets_no_gradient():
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W / H, device="cpu")
    kw = dict(width=W, height=H, spp=2, max_depth=3, seed=4)
    img = tmk.render_flat_hybrid_grad(scene, cam, **kw)
    assert not img.requires_grad  # no leaf asked for a gradient
    torch.testing.assert_close(img, tmk.render_flat_fused(scene, cam, **kw),
                               rtol=0, atol=0)
    assert sp.render_flat_hybrid_grad is tmk.render_flat_hybrid_grad
