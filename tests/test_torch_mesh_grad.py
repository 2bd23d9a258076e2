"""Gradients of the port's wavefront estimator and of its differentiable
mesh render (``render_flat_hybrid_grad_mesh``) on the CPU, against the JAX
package's.

* The estimator (``render_flat``, autograd through a checkpoint a
  sample) against ``jax.grad`` of JAX's ``render_flat``, on
  BVH-free scenes (the sphere demo, a thin lens, the Cornell box), every
  float field of the materials, spheres, triangles and camera.
* The mesh render on JAX's budget mesh (``tests/test_grad.py:260``: the
  subdivision-0 icosphere with its BVH rebuilt at leaf size 4, 48x8, spp
  1, depth 2, seed 3; a JAX walk over a deeper tree takes minutes to
  compile): its ``bwd="packet"`` and ``bwd="wavefront"`` gradients (the
  albedo and camera origin; the triangles' v0, e1, e2 at depth 3) equal
  to the bit under a linear loss (``tests/test_grad.py:526``), both
  against ``jax.grad`` of JAX's ``render_flat`` on the same scene, and
  central differences with JAX's steps and bounds.
* The sample checkpoint changes no gradient bit and keeps fewer
  tensors; the refusals.

Tolerance against JAX, as ``tests/test_torch_grad.py``'s: rtol 1e-3 plus
1e-4 of the field's largest magnitude, on the entries where JAX is
finite; the port must be finite everywhere.  The draws are JAX's bits, so
the paths are JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel.bvh import build_bvh as j_build_bvh
from spira_tpu.core.types import replace as jreplace
from spira_tpu.render import render_flat as j_render_flat
from spira_tpu.scene.geometry import triangle_bounds as j_triangle_bounds
from spira_tpu_torch.kernels import bvh_megakernel as tbk

from .test_torch_grad import FIELDS, GRAD_ATOL_SHARE, GRAD_RTOL, _params, \
    _port, _with
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

W, H = 32, 16
#: the budget mesh's render (tests/test_grad.py:260-290)
MESH_KW = dict(width=48, height=8, spp=1, max_depth=2, seed=3)


def _target(n):
    return np.random.default_rng(1).uniform(0.0, 1.0, (n, 3)).astype(
        np.float32)


def _lens_camera():
    return st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=W / H, aperture=0.2, focus_dist=3.0)


CASES = {
    # name: (scene, camera, render kwargs)
    "demo": (st.create_scene, lambda: st.default_camera(W / H),
             dict(spp=2, max_depth=3, seed=4)),
    "demo_lens": (st.create_scene, _lens_camera,
                  dict(spp=1, max_depth=2, seed=2)),
    "cornell": (st.create_cornell_box, lambda: st.cornell_camera(W / H),
                dict(spp=1, max_depth=3, seed=6)),
}


def _jax_grads(jscene, jcam, target, kw, fields):
    def loss(params):
        sc, cm = _with((jscene, jcam), params, jreplace)
        img = j_render_flat(sc, cm, **kw)
        return jnp.mean((img - target) ** 2)

    params = {k: v for k, v in _params(jscene, jcam).items() if k in fields}
    full = _params(jscene, jcam)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: loss({**full, **p})))(params)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_grads(scene, cam, target, kw, fields, render=sp.render_flat):
    leaves = {k: v.detach().clone().requires_grad_() if k in fields else v
              for k, v in _params(scene, cam).items()}
    sc, cm = _with((scene, cam), leaves, dataclasses.replace)
    img = render(sc, cm, **kw)
    loss = ((img - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    # metallic and transmission only decide branches: autograd leaves
    # them no gradient where JAX gives zeros
    return float(loss.detach()), {
        k: (torch.zeros_like(leaves[k]) if leaves[k].grad is None
            else leaves[k].grad).numpy() for k in fields}


def _assert_close_grads(got, want):
    for field, w in want.items():
        g = got[field]
        assert g.shape == w.shape and np.isfinite(g).all(), field
        ok = np.isfinite(w)
        if not ok.any():
            continue
        atol = GRAD_ATOL_SHARE * float(np.abs(w[ok]).max())
        np.testing.assert_allclose(g[ok], w[ok], rtol=GRAD_RTOL, atol=atol,
                                   err_msg=field)


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_flat_gradients_match_jax(name):
    """Every float field the estimator reads, MSE against a target: the
    materials, the sphere centres and radii, the Cornell box's triangle
    v0/e1/e2/normal, the camera frame and lens."""
    build_scene, build_cam, kw = CASES[name]
    kw = dict(width=W, height=H, **kw)
    jscene, jcam = build_scene(), build_cam()
    fields = [f for f in FIELDS
              if FIELDS[f][0] != "triangles" or name == "cornell"]
    target = _target(W * H)
    want_loss, want = _jax_grads(jscene, jcam, jnp.asarray(target), kw,
                                 fields)
    scene, cam = _port(jscene, jcam)
    got_loss, got = _port_grads(scene, cam, target, kw, fields)
    assert abs(got_loss / want_loss - 1.0) <= 1e-5
    _assert_close_grads(got, want)
    for field in ("albedo", "origin", "centers"):
        assert np.abs(got[field]).max() > 0, field
    if name == "cornell":
        assert all(np.abs(got[f]).max() > 0 for f in ("v0", "e1", "e2"))
    if name == "demo_lens":
        assert np.abs(got["lens_radius"]).max() > 0


# ---------------------------------------------------------------------------
# The mesh render on JAX's budget mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def budget_mesh():
    """(JAX scene, JAX camera, port scene with packed tables, port
    camera): JAX's budget mesh, the same BVH on both sides."""
    jscene = st.create_mesh_scene(subdivisions=0)
    lo, hi = j_triangle_bounds(jscene.triangles)
    jscene = jreplace(jscene, bvh=j_build_bvh(np.asarray(lo), np.asarray(hi),
                                              leaf_size=4))
    jcam = st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=6.0)
    scene, cam = _port(jscene, jcam)
    return jscene, jcam, sp.attach_packed(scene), cam


def _mesh_grads(scene, cam, bwd, fields, loss_fn=torch.mean, **kw):
    """d loss / d ``fields`` (names of test_torch_grad.FIELDS) of the mesh
    render."""
    leaves = {k: v.detach().clone().requires_grad_() if k in fields else v
              for k, v in _params(scene, cam).items()}
    sc, cm = _with((scene, cam), leaves, dataclasses.replace)
    img = sp.render_flat_hybrid_grad_mesh(sc, cm, bwd=bwd,
                                          **{**MESH_KW, **kw})
    loss_fn(img).backward()
    return [leaves[k].grad.numpy() for k in fields]


def _packet_wavefront_jax(budget_mesh, fields, **kw):
    """Linear loss: the cotangent does not depend on the forward, so the
    backward through the packet hook (#3's plain version here, the
    winner's hit recomputed) and through the stackless walk give the same
    bits (JAX holds its own the same way); both against jax.grad of
    render_flat, the wavefront over JAX's walk."""
    jscene, jcam, scene, cam = budget_mesh
    before = tbk.intersect_tile.launches
    packet = _mesh_grads(scene, cam, "packet", fields, **kw)
    wave = _mesh_grads(scene, cam, "wavefront", fields, **kw)
    assert tbk.intersect_tile.launches == before  # the CPU: no kernel
    for field, p, w in zip(fields, packet, wave):
        assert np.abs(p).max() > 0, field
        np.testing.assert_array_equal(p, w, err_msg=field)

    full = _params(jscene, jcam)

    def loss(params):
        sc, cm = _with((jscene, jcam), {**full, **params}, jreplace)
        return jnp.mean(j_render_flat(sc, cm, **{**MESH_KW, **kw}))

    want = jax.jit(jax.grad(loss))({k: full[k] for k in fields})
    _assert_close_grads(dict(zip(fields, packet)),
                        {k: np.asarray(v) for k, v in want.items()})


def test_packet_backward_bit_equal_to_wavefront_and_jax(budget_mesh):
    """tests/test_grad.py:526's albedo and camera origin at its shape."""
    _packet_wavefront_jax(budget_mesh, ("albedo", "origin"))


def test_triangle_gradients_bit_equal_and_match_jax(budget_mesh):
    """The winner's hit recomputed from v0, e1, e2: at depth 2 nothing
    after the mesh's hit depends on where it is (its normal is a field of
    its own, emission and sky do not depend on position), so the
    triangles take a gradient from depth 3 on, through the next hit on
    the ground sphere, whose normal does."""
    _packet_wavefront_jax(budget_mesh, ("v0", "e1", "e2"), max_depth=3)


def test_mesh_gradients_match_central_differences(budget_mesh):
    """tests/test_grad.py:260's probes on the port: MSE-like loss mean(img
    ** 2) with the wavefront forward (the backward's estimator at
    grad_spp == spp, so the loss is the function differentiated) and the
    packet backward; the camera origin's largest entry at eps 1e-4 and
    the albedo's at eps 2e-3, JAX's bounds."""
    _, _, scene, cam = budget_mesh

    def loss(albedo, origin):
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=albedo))
        img = sp.render_flat_hybrid_grad_mesh(
            sc, dataclasses.replace(cam, origin=origin), engine="wavefront",
            bwd="packet", **MESH_KW)
        return (img ** 2).mean()

    a0, o0 = scene.materials.albedo, cam.origin
    g_alb, g_cam = _mesh_grads(scene, cam, "packet", ("albedo", "origin"),
                               loss_fn=lambda img: (img ** 2).mean(),
                               engine="wavefront")
    assert np.isfinite(g_cam).all() and np.isfinite(g_alb).all()
    assert np.abs(g_cam).max() > 0 and np.abs(g_alb).max() > 0

    def value(albedo, origin):
        with torch.no_grad():
            return float(loss(albedo, origin))

    k = int(np.abs(g_cam).argmax())
    eps = 1e-4
    up, dn = o0.double().clone(), o0.double().clone()
    up[k] += eps
    dn[k] -= eps
    fd = (value(a0, up.float()) - value(a0, dn.float())) / (2 * eps)
    assert abs(fd - g_cam[k]) <= max(5e-4, 0.05 * abs(fd)), (fd, g_cam[k])

    i, j = np.unravel_index(np.abs(g_alb).argmax(), g_alb.shape)
    eps = 2e-3
    ap, am = a0.double().clone(), a0.double().clone()
    ap[i, j] += eps
    am[i, j] -= eps
    fd = (value(ap.float(), o0) - value(am.float(), o0)) / (2 * eps)
    assert abs(fd - g_alb[i, j]) <= max(2e-3, 0.03 * abs(fd)), (
        fd, g_alb[i, j])


# ---------------------------------------------------------------------------
# The checkpoints
# ---------------------------------------------------------------------------

def _sample_grads(checkpoint_samples):
    """Gradients of ``accumulate_rows`` on the Cornell box (triangles, a
    glass sphere), 2 samples of depth 4, to the albedo and the camera
    origin, with the number of tensors autograd saved outside any
    checkpoint."""
    from spira_tpu_torch.render import accumulate_rows

    scene = sp.create_cornell_box(device="cpu")
    cam = sp.cornell_camera(W / H, device="cpu")
    albedo = scene.materials.albedo.clone().requires_grad_()
    origin = cam.origin.clone().requires_grad_()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=albedo))
    cam = dataclasses.replace(cam, origin=origin)
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        rad = accumulate_rows(
            scene, cam, sp.rng.base_key(8), width=W, height=H, row_start=0,
            n_rows=H, sample_offset=0, n_samples=2, max_depth=4,
            semantics="physical", checkpoint_samples=checkpoint_samples)
    cot = torch.from_numpy(_target(W * H))
    return torch.autograd.grad(rad, (albedo, origin), cot), saved[0]


def test_bounce_checkpoints_change_no_gradient_bit():
    """A checkpointed sample replays its bounces for the gradient: the
    replay redraws the same bits and finds the same hits, so every
    gradient is the same to the bit as without the checkpoint, and
    autograd keeps no bounce's intermediates.  (No bounce is a checkpoint
    of its own: on the card that cost more time than it saved memory.)"""
    (ga, go), n_ck = _sample_grads(True)
    (ha, ho), n_plain = _sample_grads(False)
    assert ga.abs().max() > 0 and go.abs().max() > 0
    assert torch.equal(ga, ha) and torch.equal(go, ho)
    assert n_ck < n_plain / 10, (n_ck, n_plain)


def test_sample_checkpoint_value_only_frame_adds_nothing(budget_mesh):
    """accumulate_rows checkpoints a sample only when a gradient is being
    taken: a value-only frame keeps no tensor; under grad, the
    checkpointed samples give the same bits as samples kept whole."""
    from spira_tpu_torch.render import accumulate_rows

    _, _, scene, cam = budget_mesh
    kw = dict(width=48, height=8, row_start=0, n_rows=8, sample_offset=0,
              n_samples=2, max_depth=2, semantics="physical")
    base = sp.rng.base_key(3)
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        value = accumulate_rows(scene, cam, base, **kw)
    assert saved[0] == 0 and not value.requires_grad
    grads = []
    for checkpoint_samples in (True, False):
        origin = cam.origin.clone().requires_grad_()
        acc = accumulate_rows(scene, dataclasses.replace(cam, origin=origin),
                              base, checkpoint_samples=checkpoint_samples,
                              **kw)
        assert torch.equal(acc.detach(), value)
        grads.append(torch.autograd.grad(acc.sum(), origin)[0])
    assert grads[0].abs().max() > 0 and torch.equal(*grads)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_mesh_grad_refusals(budget_mesh):
    _, _, scene, cam = budget_mesh
    kw = dict(width=8, height=4, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="scene.packed"):
        sp.render_flat_hybrid_grad_mesh(
            dataclasses.replace(scene, packed=None), cam, bwd="packet", **kw)
    no_map = dataclasses.replace(scene, packed=dataclasses.replace(
        scene.packed, prim_map=None))
    with pytest.raises(ValueError, match="prim_map"):
        sp.render_flat_hybrid_grad_mesh(no_map, cam, bwd="packet", **kw)
    for engine in ("pallas_bvh_interpret", "pallas_bvh", "cuda"):
        with pytest.raises(ValueError, match="cuda_bvh, cuda_bvh_mxu, "
                           "wavefront"):
            sp.render_flat_hybrid_grad_mesh(scene, cam, engine=engine, **kw)
    for bwd in ("packet_interpret", "stack"):
        with pytest.raises(ValueError, match="bwd"):
            sp.render_flat_hybrid_grad_mesh(scene, cam, bwd=bwd, **kw)
    with pytest.raises(ValueError, match="grad_spp"):
        sp.render_flat_hybrid_grad_mesh(scene, cam, grad_spp=0, **kw)
    # off the card the defaults are the wavefront both ways: a scene
    # without packed tables takes a gradient
    origin = cam.origin.clone().requires_grad_()
    img = sp.render_flat_hybrid_grad_mesh(
        dataclasses.replace(scene, packed=None),
        dataclasses.replace(cam, origin=origin), **kw)
    img.sum().backward()
    assert torch.isfinite(origin.grad).all()
