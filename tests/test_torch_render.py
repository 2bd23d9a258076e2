"""The port's slice as a whole: ``spira_tpu_torch.render`` against
``spira_tpu.render(..., engine="fused")``, the image I/O, the paths that
are not ported yet, and an import that leaves JAX out."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.io import image as jimg
from spira_tpu_torch.io import image as timg

torch.set_num_threads(1)

W, H = 64, 16
KW = dict(samples_per_pixel=2, max_depth=2, seed=5)


@pytest.fixture(scope="module")
def scenes():
    jscene, jcam = st.create_scene(), st.default_camera(W / H)
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (jscene, jcam), (sp.scene_from_numpy(as_np[0], device="cpu"),
                            sp.camera_from_numpy(as_np[1], device="cpu"))


def test_render_matches_jax_uint8(scenes):
    """Same scene values and seed: the tone-mapped uint8 images agree to
    within one level on at least 99% of values, and their means to 0.05."""
    (jscene, jcam), (scene, cam) = scenes
    want = st.render(jscene, jcam, W, H, engine="fused", **KW)
    got = sp.render(scene, cam, W, H, **KW)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    gap = np.abs(got.astype(int) - want.astype(int))
    assert (gap <= 1).mean() >= 0.99
    assert abs(got.mean() - want.mean()) < 0.05


def test_render_hdr_top_down_and_engines(scenes):
    _, (scene, cam) = scenes
    kw = dict(spp=1, max_depth=2, seed=1)
    flat = sp.render_flat_engine(scene, cam, width=W, height=H, **kw)
    hdr = sp.render_hdr(scene, cam, W, H, **kw)
    assert hdr.shape == (H, W, 3)
    # row 0 of the top-down image is the last row of the bottom-up buffer
    torch.testing.assert_close(hdr[0], flat[(H - 1) * W:], rtol=0, atol=0)
    assert sp.select_engine(scene, "physical", False) == "fused"
    for engine in ("fused", "cuda"):  # "cuda" on CPU tensors: plain version
        out = sp.render_flat_engine(scene, cam, width=W, height=H,
                                    engine=engine, **kw)
        torch.testing.assert_close(out, flat, rtol=0, atol=0)


def test_render_writes_png_ppm_exr(scenes, tmp_path):
    _, (scene, cam) = scenes
    kw = dict(samples_per_pixel=1, max_depth=1)
    img = sp.render(scene, cam, W, H, output_path=str(tmp_path / "a.png"),
                    **kw)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
    sp.render(scene, cam, W, H, output_path=str(tmp_path / "a.ppm"), **kw)
    assert (tmp_path / "a.ppm").read_bytes().startswith(b"P6\n64 16\n255\n")
    sp.render(scene, cam, W, H, output_path=str(tmp_path / "a.exr"), **kw)
    hdr = sp.render_hdr(scene, cam, W, H, spp=1, max_depth=1)
    np.testing.assert_array_equal(jimg.load_exr(str(tmp_path / "a.exr")),
                                  hdr.numpy())


def test_pure_png_writer_matches_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    timg._save_png_pure(str(tmp_path / "p.png"), img)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  img)


@pytest.mark.parametrize("tonemap", ["gamma", "aces", "none"])
def test_image_io_matches_jax(tonemap):
    """Assembly, tone maps and uint8 quantisation against spira_tpu.io."""
    rng = np.random.default_rng(1)
    flat = (rng.random((H * W, 3), np.float32) * 3.0).astype(np.float32)
    want_hdr = np.asarray(jimg.assemble_image(flat, W, H))
    hdr = timg.assemble_image(torch.from_numpy(flat), W, H)
    np.testing.assert_array_equal(hdr.numpy(), want_hdr)
    want = np.asarray(jimg.TONEMAPS[tonemap](want_hdr))
    got = timg.TONEMAPS[tonemap](hdr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ldr = np.clip(want, 0.0, 1.0)
    np.testing.assert_array_equal(timg.to_uint8(torch.from_numpy(ldr)),
                                  jimg.to_uint8(ldr))


def _bvh_scene(scene):
    """The demo spheres over a mesh with a flat BVH (no packed tables)."""
    mesh = sp.create_mesh_scene(subdivisions=1, device="cpu")
    return dataclasses.replace(scene, triangles=mesh.triangles,
                               bvh=mesh.bvh)


def _packed_scene(scene):
    return dataclasses.replace(scene, packed=object())


def _big_mesh(scene):
    verts = np.array([[i, i % 2, -2.0] for i in range(35)], np.float32)
    faces = np.array([[i, i + 1, i + 2] for i in range(33)])
    return dataclasses.replace(scene,
                               triangles=sp.make_triangles(verts, faces, 0,
                                                        device="cpu"))


@pytest.mark.parametrize(
    "scene_fn,kw,match",
    [
        pytest.param(None, dict(shading="preview"), "shading",
                     id="None-kw2-shading"),
        pytest.param(None, dict(engine="pallas_bvh"), "engine 'pallas_bvh'",
                     id="None-kw4-engine 'pallas_bvh'"),
    ],
)
def test_unported_paths_raise(scenes, scene_fn, kw, match):
    _, (scene, cam) = scenes
    if scene_fn is not None:
        scene = scene_fn(scene)
    with pytest.raises(NotImplementedError, match=match) as err:
        sp.render(scene, cam, 16, 8, samples_per_pixel=1, max_depth=1, **kw)
    assert "ROADMAP.md" in str(err.value)
    assert "item 10" not in str(err.value)


@pytest.mark.parametrize(
    "scene_fn,kw,engine",
    [
        (None, dict(spectral=True, semantics="reference"), "wavefront"),
        (None, dict(semantics="reference"), "wavefront"),
        (None, dict(engine="wavefront"), "wavefront"),
        (_bvh_scene, {}, "wavefront"),
        (_packed_scene, {}, "fused"),
        (_big_mesh, {}, "wavefront"),
    ],
)
def test_wavefront_paths_route_as_jax(scenes, scene_fn, kw, engine):
    """The paths the wavefront estimator brought (each raised
    NotImplementedError before it): the engine JAX's select_engine picks
    off the TPU, and a rendered image."""
    _, (scene, cam) = scenes
    if scene_fn is not None:
        scene = scene_fn(scene)
    assert sp.select_engine(scene, kw.get("semantics", "physical"),
                            kw.get("spectral", False),
                            kw.get("engine", "auto")) == engine
    img = sp.render(scene, cam, 16, 8, samples_per_pixel=1, max_depth=2,
                    **kw)
    assert img.shape == (8, 16, 3) and img.dtype == np.uint8
    assert img.std() > 0


def test_import_leaves_jax_out():
    code = (
        "import sys, spira_tpu_torch\n"
        "from spira_tpu_torch.kernels import megakernel, bvh_megakernel\n"
        "from spira_tpu_torch.kernels import spectral_fused, spectral_bvh\n"
        "from spira_tpu_torch.core import colorimetry\n"
        "from spira_tpu_torch.accel import bvh, mxu, native, pairs, wide\n"
        "from spira_tpu_torch.kernels import mxu_megakernel\n"
        "from spira_tpu_torch import experiments\n"
        "from spira_tpu_torch.scene import bunny, obj\n"
        "from spira_tpu_torch.accel import traverse\n"
        "from spira_tpu_torch.integrator import bsdf, path_trace, spectral\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'spira_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)
