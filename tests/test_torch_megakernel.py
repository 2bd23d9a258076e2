"""The port's plain tracer (``render_flat_fused``) against the JAX fused
render, on the JAX package's exact scene and camera values (through the
converter), and the kernel wrapper's checks.

Tolerances (the same inputs and seed on both sides): per-channel image
means within 0.5% relative, and at least 99% of pixel-channels within
1e-4 absolute; at depth 1 (primary hits and raygen jitter only) at least
99.9% within 1e-5.  XLA contracts multiply-adds and evaluates rsqrt, sin,
cos and log by its own approximations, so values differ in the last bits;
after a few bounces a rare branch flip can move a whole path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.kernels import megakernel as jmk
from spira_tpu.scene.geometry import make_triangles as jax_make_triangles
from spira_tpu_torch.kernels import megakernel as tmk
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

MEAN_REL = 0.005
DEEP = dict(atol=1e-4, frac=0.99)
PRIMARY = dict(atol=1e-5, frac=0.999)


def _quad_scene():
    """The demo scene plus a 2-triangle back wall (the triangle loop)."""
    scene = st.create_scene()
    verts = np.array(
        [[-2, -0.5, -1.5], [2, -0.5, -1.5], [2, 1.5, -1.5], [-2, 1.5, -1.5]],
        np.float32,
    )
    quad = jax_make_triangles(verts, np.array([[0, 1, 2], [0, 2, 3]]), 2)
    return dataclasses.replace(scene, triangles=quad)


def _lens_camera(aspect):
    return st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=aspect, aperture=0.2, focus_dist=3.0)


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _assert_images_agree(got, want, atol, frac):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= atol).mean() >= frac


CASES = {
    # name: (scene, camera, render kwargs, tolerance)
    "depth1_quad": (_quad_scene, lambda: st.default_camera(4.0),
                    dict(width=128, height=32, spp=4, max_depth=1, seed=0),
                    PRIMARY),
    "depth4": (st.create_scene, lambda: st.default_camera(4.0),
               dict(width=128, height=32, spp=4, max_depth=4, seed=3),
               DEEP),
    # Russian roulette fires at bounce index > 3: depth 6 reaches it
    "depth6_rr_quad": (_quad_scene, lambda: st.default_camera(4.0),
                       dict(width=64, height=16, spp=2, max_depth=6, seed=2),
                       DEEP),
    "thin_lens": (st.create_scene, lambda: _lens_camera(4.0),
                  dict(width=128, height=32, spp=2, max_depth=2, seed=1),
                  DEEP),
    # u = col / W, v = row / H in place of col / (W - 1), row / (H - 1)
    "exclusive_uv": (st.create_scene, lambda: st.default_camera(2.0),
                     dict(width=16, height=8, spp=1, max_depth=2, seed=0,
                          inclusive_uv=False), DEEP),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_matches_jax(name):
    build_scene, build_cam, kw, tol = CASES[name]
    jscene, jcam = build_scene(), build_cam()
    want = np.asarray(jmk.render_flat_fused(jscene, jcam, **kw))
    scene, cam = _port(jscene, jcam)
    got = tmk.render_flat_fused(scene, cam, **kw)
    assert got.dtype == torch.float32
    _assert_images_agree(got.numpy(), want, **tol)


def test_fused_matches_pallas_interpret():
    """The JAX side above is the fused XLA twin; tie the port to the Pallas
    kernel itself once, run in interpret mode."""
    jscene, jcam = st.create_scene(), st.default_camera(2.0)
    kw = dict(width=128, height=8, spp=1, max_depth=2, seed=0)
    want = np.asarray(
        jmk.render_flat_megakernel(jscene, jcam, interpret=True, **kw)
    )
    scene, cam = _port(jscene, jcam)
    got = tmk.render_flat_megakernel(scene, cam, **kw).numpy()
    _assert_images_agree(got, want, **DEEP)


def test_russian_roulette_reached_at_depth6():
    """Depth 6 changes the image against depth 4 (paths live past bounce
    3, where roulette starts), and both stay finite."""
    scene, cam = _port(_quad_scene(), st.default_camera(4.0))
    kw = dict(width=64, height=16, spp=2, seed=2)
    d4 = tmk.render_flat_fused(scene, cam, max_depth=4, **kw)
    d6 = tmk.render_flat_fused(scene, cam, max_depth=6, **kw)
    assert torch.isfinite(d6).all()
    assert (d4 != d6).any()


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    kw = dict(width=32, height=8, spp=1, max_depth=2, seed=4)
    before = tmk.render_flat_megakernel.launches
    got = tmk.render_flat_megakernel(scene, cam, **kw)
    assert tmk.render_flat_megakernel.launches == before
    torch.testing.assert_close(got, tmk.render_flat_fused(scene, cam, **kw),
                               rtol=0, atol=0)


def _strip(n_tris):
    verts = np.array(
        [[i, 0.0, -2.0] for i in range(n_tris + 2)], np.float32
    ) + np.array([[0.0, (i % 2), 0.0] for i in range(n_tris + 2)], np.float32)
    faces = np.array([[i, i + 1, i + 2] for i in range(n_tris)])
    return sp.make_triangles(verts, faces, 0, device="cpu")


def test_rejects_more_than_32_triangles():
    scene = dataclasses.replace(sp.create_scene(device="cpu"),
                                triangles=_strip(33))
    cam = sp.default_camera(1.0, device="cpu")
    for fn in (tmk.render_flat_megakernel, tmk.render_flat_fused):
        with pytest.raises(ValueError, match="at most 32"):
            fn(scene, cam, width=16, height=8, spp=1, max_depth=1)
    ok = dataclasses.replace(sp.create_scene(device="cpu"),
                             triangles=_strip(32))
    out = tmk.render_flat_fused(ok, cam, width=16, height=8, spp=1,
                                max_depth=1)
    assert out.shape == (128, 3)


def test_wrapper_refuses_other_devices():
    scene = sp.create_scene(device="cpu").to("meta")
    cam = sp.default_camera(2.0, device="cpu").to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmk.render_flat_megakernel(scene, cam, width=16, height=8)


def test_kernel_sources_and_build_flags():
    """The kernel's sources ship in the package, the build is for sm_90a
    without FMA contraction or fast-math, and importing the package builds
    nothing."""
    from spira_tpu_torch import _build

    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"megakernel.cu", "trace.cuh", "pcg.cuh"} <= names
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert len(_build._source_hash("megakernel")) == 16
