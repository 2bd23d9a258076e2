"""The examples' twins (``spira_tpu_torch.examples``) against the same
calls through the JAX API, on the CPU at small sizes, under the parity
contract of ROADMAP.md.  Tolerances, stated beside each test:

* images (uint8, as the scripts write them): channel means within
  ``MEAN_REL``, the RMSE within ``RMSE_LEVELS`` levels and at most
  ``DIFF_FRAC`` of the pixels more than ``DIFF_LEVELS`` levels apart: the
  PCG4D draws are bit-exact, but transcendentals differ across backends
  and a rare branch flip moves a whole path;
* the adaptive run as ``tests/test_torch_pipeline.py`` holds the adaptive
  renderer: at least 80% of the rows retire at JAX's spp, the spp maps'
  means within 10%, the image means within 2%, the RMSE below a quarter of
  the mean;
* the inverse loop as ``tests/test_torch_inverse.py`` holds it: the loss
  of each step within 1e-5 relative, the parameters within 1e-5;
* the distributed render in a 2-rank gloo world (started as
  ``tests/test_torch_sharded.py`` starts one) against the same example in
  one process within ``SUM_ORDER`` (a split of the samples adds them in
  another order), and against JAX's sharded render of the same mesh
  shape as ``tests/test_torch_sharded.py`` holds the ``fused`` tracer.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
from spira_tpu import pipeline as jpipe
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.diff.inverse import make_inverse_step as j_make_inverse_step
from spira_tpu.io import image as jimg
from spira_tpu.kernels import bvh_megakernel as jbk
from spira_tpu.parallel.mesh import make_mesh as j_make_mesh
from spira_tpu.parallel.sharded import render_flat_sharded as j_sharded
from spira_tpu.render import render_flat as j_render_flat
from spira_tpu.utils.config import RenderConfig as JRenderConfig
from spira_tpu_torch.examples import (
    adaptive_render,
    basic_render,
    cornell_spectral,
    distributed_render,
    dof_render,
    inverse_rendering,
    mesh_bvh,
)
from spira_tpu_torch.io import image as timg

from ._torch_native import same_native_library  # noqa: F401
from .test_torch_sharded import FUSED, SUM_ORDER, spawn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREFOIL = os.path.join(ROOT, "assets", "trefoil.obj")
W, H = 32, 16
MEAN_REL, RMSE_LEVELS, DIFF_LEVELS, DIFF_FRAC = 0.005, 2.0, 1, 0.01


def _close_images(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and got.std() > 1.0
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)),
                               rtol=MEAN_REL)
    assert np.sqrt(np.mean((got - want) ** 2)) <= RMSE_LEVELS
    apart = (np.abs(got - want) > DIFF_LEVELS).any(-1).mean()
    assert apart <= DIFF_FRAC, apart


def _written(path, img):
    """The PNG the example wrote is the image it returned."""
    np.testing.assert_array_equal(timg.load_png(str(path)), img)


def test_basic_render(tmp_path):
    out = tmp_path / "basic.png"
    img = basic_render.run(str(out), width=W, height=H, spp=4, device="cpu")
    want = st.render(st.create_scene(), st.default_camera(W / H), W, H,
                     samples_per_pixel=4, max_depth=4)
    _close_images(img, want)
    _written(out, img)


def test_dof_render(tmp_path):
    out = tmp_path / "dof.png"
    img = dof_render.run(str(out), width=W, height=H, spp=4, device="cpu")
    cam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                         vfov=60.0, aspect_ratio=W / H, aperture=0.35,
                         focus_dist=3.2)
    want = st.render(st.create_scene(), cam, W, H, samples_per_pixel=4,
                     max_depth=4)
    _close_images(img, want)
    _written(out, img)
    sharp = basic_render.run(None, width=W, height=H, spp=4, device="cpu")
    assert not np.array_equal(img, sharp)


def test_cornell_spectral(tmp_path):
    """Depth 2: JAX's XLA compile of the box takes ~30 s there and ~110 s
    at depth 3."""
    out = tmp_path / "cornell.png"
    img = cornell_spectral.run(str(out), 2, width=W, height=W, max_depth=2,
                               device="cpu")
    want = st.render(st.create_cornell_box(), st.cornell_camera(1.0), W, W,
                     samples_per_pixel=2, max_depth=2, spectral=True,
                     tonemap="aces")
    _close_images(img, want)
    _written(out, img)


def test_mesh_bvh(tmp_path):
    """The trefoil through the packed tables: the port's #2 (its plain
    version on the CPU) against JAX's packet kernel in interpret mode."""
    out = tmp_path / "mesh.png"
    img, count = mesh_bvh.run(TREFOIL, str(out), width=W, height=H, spp=2,
                              max_depth=2, engine="cuda_bvh", device="cpu")
    jscene = j_attach_packed(st.create_mesh_scene(obj_path=TREFOIL))
    cam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                         vfov=50.0, aspect_ratio=W / H)
    flat = jbk.render_flat_bvh_megakernel(jscene, cam, width=W, height=H,
                                          spp=2, max_depth=2, seed=0,
                                          interpret=True)
    want = jimg.to_uint8(jimg.tonemap_gamma(jimg.assemble_image(flat, W, H)))
    assert count == jscene.triangles.count
    _close_images(img, want)
    _written(out, img)


def test_adaptive_render(tmp_path):
    """128x8, cap 8, at least 2, chunk 2, tol 0.1: rows retire at 2 and
    8 spp."""
    kw = dict(width=128, height=8, spp=8, min_spp=2, chunk=2)
    out = tmp_path / "adaptive.png"
    img, stats = adaptive_render.run(str(out), 0.1, device="cpu", **kw)
    cfg = JRenderConfig(width=128, height=8, spp=8, max_depth=4,
                        progress=False)
    jimg_, jstats = jpipe.render_adaptive(
        st.create_scene(), st.default_camera(128 / 8), cfg, tol=0.1,
        min_spp=2, chunk=2, return_stats=True)
    spp, jspp = stats["spp_per_row"], jstats["spp_per_row"]
    assert len(np.unique(jspp)) >= 2
    assert (spp == jspp).mean() >= 0.8
    np.testing.assert_allclose(spp.mean(), jspp.mean(), rtol=0.1)
    np.testing.assert_allclose(img.mean(), jimg_.mean(), rtol=0.02)
    assert np.sqrt(np.mean((img - jimg_) ** 2)) < 0.25 * jimg_.mean()
    np.testing.assert_allclose(stats["savings"], jstats["savings"],
                               rtol=0.1)
    assert sum(int(line.split()[-2]) for line in adaptive_render.histogram(
        spp, 8)) == 8
    assert timg.load_png(str(out)).shape == (8, 128, 3)


def test_inverse_rendering(tmp_path):
    """Three Adam steps at 3e-2 from albedo 0.5 and emission 1 towards a
    spp-4 target at seed 1234, 16x8 spp 2 depth 2."""
    kw = dict(width=16, height=8, spp=2, max_depth=2)
    out = tmp_path / "inverse.png"
    params, losses, _ = inverse_rendering.run(3, target_spp=4, out=str(out),
                                              device="cpu", **kw)
    jscene, jcam = st.create_scene(), st.default_camera(16 / 8)
    target = j_render_flat(jscene, jcam, width=16, height=8, spp=4,
                           max_depth=2, seed=1234)
    step, init = j_make_inverse_step(learning_rate=3e-2, **kw)
    jparams = {"albedo": jnp.full_like(jscene.materials.albedo, 0.5),
               "emission": jnp.zeros_like(jscene.materials.emission) + 1.0}
    opt = init(jparams)
    jlosses = []
    for it in range(3):
        jparams, opt, loss = step(jparams, opt, jscene, jcam, target, it)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert timg.load_png(str(out)).shape == (8, 16, 3)


def test_distributed_render(tmp_path):
    """Two ranks (the spp axis: n_spp 2, n_tile 1) against the same
    example in one process and JAX's render on a (1, 2) mesh."""
    kw = dict(width=W, height=H, spp=4, max_depth=2)
    one, mesh = distributed_render.run(None, device="cpu", log=lambda *a: 0,
                                       **kw)
    assert mesh.shape == dict(tile=1, spp=1)
    ranks = spawn("example", 2, tmp_path, dict(example=kw))
    assert [r["shape"] for r in ranks] == [dict(tile=1, spp=2)] * 2
    assert [r["wrote"] for r in ranks] == [True, False]  # rank 0 writes
    np.testing.assert_array_equal(ranks[0]["img"], ranks[1]["img"])
    np.testing.assert_allclose(ranks[0]["img"], one, rtol=0,
                               atol=SUM_ORDER * one.max())
    jscene, jcam = st.create_scene(), st.default_camera(W / H)
    want = np.asarray(j_sharded(jscene, jcam, mesh=j_make_mesh(1, 2),
                                engine="fused", **kw))
    assert (np.abs(ranks[0]["img"] - want) <= FUSED["atol"]).mean() \
        >= FUSED["frac"]


@pytest.mark.parametrize("module,argv", [
    (basic_render, []), (dof_render, []), (cornell_spectral, ["x.png", "2"]),
    (mesh_bvh, [TREFOIL, "x.png"]), (adaptive_render, ["x.png", "0.1"]),
    (inverse_rendering, ["1"]), (distributed_render, [])])
def test_main_runs_on_the_card_only(module, argv, monkeypatch, tmp_path):
    """Each ``__main__`` parses the JAX script's arguments and renders on
    the card; on a host without one it raises before writing anything:
    nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not os.listdir(tmp_path)
