"""The port's inverse-rendering loop (``spira_tpu_torch.diff.inverse``)
against the JAX package's on the CPU, on the sphere demo at 16x8, spp 2,
depth 3 (BVH-free: a JAX gradient through a BVH walk takes minutes to
compile).

* ``render_for_grad``'s loss and gradients against ``jax.value_and_grad``
  of JAX's: the loss within 1e-5 relative, each gradient within 1e-4
  relative L2 where JAX is finite (``tests/test_torch_mesh_grad.py``'s
  bound).
* Three steps of ``make_inverse_step`` against JAX's: the parameters
  within 1e-5 after each step.
* ``torch.optim.Adam`` against ``optax.adam`` on fixed gradients: within
  5e-6 absolute over 30 steps (the two round in different orders).
* The albedo recovery of JAX's ``tests/test_grad.py:83`` at this size, the
  train checkpoint's exact resume, the packed hook's gradients, and the
  refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.diff import inverse as jinv
from spira_tpu_torch.diff import inverse
from spira_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

W, H, SPP, DEPTH = 16, 8, 2, 3
KW = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)
#: the perturbed albedo of JAX's recovery test (materials 0 and 1)
ALBEDO01 = ((0.2, 0.7, 0.7), (0.9, 0.2, 0.9))


def _demo():
    jscene, jcam = st.create_scene(), st.default_camera(W / H)
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (jscene, jcam, sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _target():
    return np.random.default_rng(1).uniform(0.0, 1.0, (W * H, 3)).astype(
        np.float32)


def _start(scene):
    albedo = scene.materials.albedo.numpy().copy()
    albedo[:2] = ALBEDO01
    emission = scene.materials.emission.numpy() * 0.5 + 0.25
    return {"albedo": albedo, "emission": emission}


def _rel_l2(got, want):
    ok = np.isfinite(want)
    return (np.linalg.norm(got[ok] - want[ok])
            / max(np.linalg.norm(want[ok]), 1e-30))


def test_render_for_grad_matches_jax():
    jscene, jcam, scene, cam = _demo()
    target = _target()
    start = _start(scene)

    def jloss(params):
        img = jinv.render_for_grad(params, jscene, jcam, seed=5, **KW)
        return jinv.mse_loss(img, jnp.asarray(target))

    want_loss, want_g = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in start.items()})
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in start.items()}
    loss = inverse.mse_loss(inverse.render_for_grad(
        params, scene, cam, seed=5, **KW), torch.from_numpy(target))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for (name, g) in zip(params, grads):
        g = g.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        assert _rel_l2(g, np.asarray(want_g[name])) <= 1e-4, name


def test_three_inverse_steps_match_jax():
    """Adam at 2e-2 on the albedo and emission of the demo, three steps,
    fresh seeds 0, 1, 2: the parameters within 1e-5 after each step, the
    losses within 1e-5 relative."""
    jscene, jcam, scene, cam = _demo()
    target = _target()
    start = _start(scene)
    jstep, jinit = jinv.make_inverse_step(**KW, learning_rate=2e-2)
    step, init = inverse.make_inverse_step(**KW, learning_rate=2e-2)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jopt = jinit(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    opt = init(params)
    for it in range(3):
        jparams, jopt, jl = jstep(jparams, jopt, jscene, jcam,
                                  jnp.asarray(target), it)
        params, opt, loss = step(params, opt, scene, cam,
                                 torch.from_numpy(target), it)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-5, err_msg=f"{k} step {it}")
    assert not np.allclose(params["albedo"].detach().numpy(),
                           start["albedo"])


def test_adam_matches_optax():
    """``torch.optim.Adam`` and ``optax.adam`` compute the same update,
    ``lr · m̂ / (sqrt(v̂) + eps)``, rounded in another order: 30 steps of
    fixed gradients from 1e-6 to 1 in magnitude agree within 5e-6."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
    grads = (rng.standard_normal((30, 6, 5))
             * 10.0 ** rng.integers(-6, 1, (30, 6, 5))).astype(np.float32)
    opt = optax.adam(2e-2)
    jx = jnp.asarray(x0)
    state = opt.init(jx)
    tx = torch.from_numpy(x0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([tx], lr=2e-2, foreach=False)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jx)
        jx = optax.apply_updates(jx, updates)
        tx.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=5e-6)


def test_inverse_recovers_albedo():
    """JAX's ``test_inverse_rendering_recovers_albedo`` at 16x8, depth 3:
    the albedo of materials 0 and 1 perturbed, 60 Adam steps at 5e-2
    against a spp-8 target, the error at least halved, the last 10 losses
    below half the first 5."""
    _, _, scene, cam = _demo()
    true_albedo = scene.materials.albedo.clone()
    target = sp.render_flat(scene, cam, width=W, height=H, spp=8,
                            max_depth=DEPTH, seed=99)
    step, init = inverse.make_inverse_step(**KW, learning_rate=5e-2)
    albedo0 = true_albedo.clone()
    albedo0[:2] = torch.tensor(ALBEDO01)
    params = {"albedo": albedo0.clone()}
    opt = init(params)
    losses = []
    for it in range(60):
        params, opt, loss = step(params, opt, scene, cam, target, it)
        losses.append(float(loss))
    err0 = float((albedo0[:2] - true_albedo[:2]).abs().mean())
    err1 = float((params["albedo"].detach()[:2]
                  - true_albedo[:2]).abs().mean())
    assert err1 < 0.5 * err0, (err0, err1)
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5])
    assert float(params["albedo"].detach().min()) >= 0.0
    assert float(params["albedo"].detach().max()) <= 1.0


def test_train_checkpoint_resumes_exactly(tmp_path):
    """Two steps, a train checkpoint, two more steps from it in a fresh
    loop: the same parameters and Adam state, to the bit, as four steps
    without a break."""
    _, _, scene, cam = _demo()
    target = torch.from_numpy(_target())
    step, init = inverse.make_inverse_step(**KW)

    def fresh():
        params = {k: torch.from_numpy(v) for k, v in
                  _start(scene).items()}
        return params, init(params)

    params, opt = fresh()
    for it in range(4):
        if it == 2:
            ckpt.save_train_state(str(tmp_path), params=params,
                                  opt_state=opt, step=it)
        params, opt, _ = step(params, opt, scene, cam, target, it)
    resumed, ropt = fresh()
    resumed, ropt, start = ckpt.load_train_state(str(tmp_path), resumed,
                                                 ropt)
    assert start == 2
    for it in range(start, 4):
        resumed, ropt, _ = step(resumed, ropt, scene, cam, target, it)
    for k in params:
        assert torch.equal(resumed[k], params[k]), k
    for a, b in zip(ropt.state.values(), opt.state.values()):
        for field in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[field], b[field]), field


def test_packet_hook_gradients_equal_the_walk():
    """On a packed mesh scene ``intersect="packet"`` (the packed-BVH hook
    in its differentiable form; the plain query on the CPU, kernel #3 on
    the card) gives the stackless walk's loss and gradients to the bit."""
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device="cpu")
    target = torch.full((W * H, 3), 0.3)
    out = []
    for intersect in (None, "packet"):
        params = {"albedo": scene.materials.albedo.clone().requires_grad_()}
        loss = inverse.mse_loss(inverse.render_for_grad(
            params, scene, cam, width=W, height=H, spp=1, max_depth=2,
            seed=3, intersect=intersect), target)
        out.append((loss, *torch.autograd.grad(loss, [params["albedo"]])))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and out[0][1].abs().max() > 0


def test_refusals():
    """A mesh of one rank (no process group): ``render_for_grad(mesh=)``
    is the unsharded render to the bit and ``make_inverse_step(mesh=)``
    the unsharded step's parameters to the bit (the loss within float-sum
    order); a spp that does not divide by the spp axis raises JAX's
    ``ValueError``; JAX's TPU knob and a parameter that is not a leaf are
    refused."""
    from spira_tpu_torch.parallel import Mesh, make_mesh

    _, _, scene, cam = _demo()
    mesh = make_mesh(1, 1, device="cpu")
    start = _start(scene)
    params = {k: torch.from_numpy(v) for k, v in start.items()}
    assert torch.equal(
        inverse.render_for_grad(params, scene, cam, seed=0, mesh=mesh, **KW),
        inverse.render_for_grad(params, scene, cam, seed=0, **KW))
    target = torch.from_numpy(_target())
    out = []
    for m in (None, mesh):
        step, init = inverse.make_inverse_step(**KW, mesh=m)
        p = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        p, _, loss = step(p, init(p), scene, cam, target, 0)
        out.append((float(loss), p))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for k in start:
        assert torch.equal(out[1][1][k], out[0][1][k]), k
    with pytest.raises(ValueError, match="not divisible by spp axis 4"):
        inverse.render_for_grad({}, scene, cam, seed=0, **KW, mesh=Mesh(
            n_tile=1, n_spp=4, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="packet_interpret"):
        inverse.render_for_grad({}, scene, cam, seed=0,
                                intersect="packet_interpret", **KW)
    _, init = inverse.make_inverse_step(**KW)
    with pytest.raises(ValueError, match="leaf"):
        leaf = torch.ones(3, requires_grad=True)
        init({"albedo": leaf * 2.0})
