"""The wavefront estimator against the JAX package's, same scene values and
seed: ``trace`` in physical and reference semantics, ``trace_spectral``,
``render_flat`` as a whole; the packed-BVH hook inside ``accumulate_rows``
against the scene's own traversal; ``render_with_cpu`` against the scalar
reference oracle; and the entry points.

Tolerances: the draws are JAX's bits, so the paths are the same; a
transcendental or a summation that differs in its last bit may still flip
a branch and move a whole path.  So at least 99% of rays (pixels) within
rtol 1e-4 / atol 1e-5 and the channel means within 1e-4 relative.  The
hook against the traversal: JAX's own tolerance for its sorted hook
(rtol 1e-3 / atol 1e-4, ``tests/test_bvh_sorted.py``).  The oracle: the
thresholds of ``tests/test_golden_reference.py``."""

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.core import rng as jr
from spira_tpu.integrator import path_trace as jpt
from spira_tpu.integrator import spectral as jspec
from spira_tpu.render import render_flat as j_render_flat
from spira_tpu.scene.camera import generate_rays as j_generate_rays
from spira_tpu_torch.integrator import path_trace as tpt
from spira_tpu_torch.integrator import spectral as tspec
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.render import accumulate_rows

from .reference_impl import (
    CPUReferenceRenderer,
    default_camera_dict,
    default_scene,
)

torch.set_num_threads(1)

RTOL, ATOL, FRAC, MEAN_REL = 1e-4, 1e-5, 0.99, 1e-4
HOOK_RTOL, HOOK_ATOL = 1e-3, 1e-4


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _close(got, want):
    """(N, 3) estimates: the share of rows within RTOL / ATOL, and the
    channel means."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    frac = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1).mean()
    assert frac >= FRAC, frac
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)


def _glass_closeup():
    """The Cornell box seen through its dispersive glass sphere."""
    return st.create_cornell_box(), st.make_camera(
        (0.45, -0.7, 1.5), (0.45, -0.7, 0.25), vfov=10.0, aspect_ratio=1.0)


def _rays(jcam, cam, w, h, seed, sample):
    jk = jax.random.fold_in(jr.sample_key(jr.base_key(seed), sample), 0)
    tk = sp.rng.fold_in(sp.rng.sample_key(sp.rng.base_key(seed), sample), 0)
    return (jk, *j_generate_rays(jcam, w, h, jk)), (tk, *sp.generate_rays(
        cam, w, h, tk))


@pytest.mark.parametrize("scene_name,semantics", [
    ("demo", "physical"), ("demo", "reference"), ("cornell", "physical")])
def test_trace_matches_jax(scene_name, semantics):
    """16x8 rays, depth 3 (the Cornell box: 12 triangles brute force and
    a glass sphere)."""
    w, h = 16, 8
    if scene_name == "demo":
        jscene, jcam = st.create_scene(), st.default_camera(w / h)
    else:
        jscene, jcam = st.create_cornell_box(), st.cornell_camera(w / h)
    scene, cam = _port(jscene, jcam)
    (jk, jo, jd), (tk, to, td) = _rays(jcam, cam, w, h, seed=5, sample=1)
    want = jpt.trace(jscene, jo, jd, jk, max_depth=3, semantics=semantics)
    got = tpt.trace(scene, to, td, tk, max_depth=3, semantics=semantics)
    _close(got, want)


@pytest.mark.parametrize("which", ["demo", "glass"])
def test_trace_spectral_matches_jax(which):
    """4x4 rays, depth 2; through the glass sphere most paths collapse to
    their hero wavelength."""
    jscene, jcam = ((st.create_scene(), st.default_camera(1.0))
                    if which == "demo" else _glass_closeup())
    scene, cam = _port(jscene, jcam)
    (jk, jo, jd), (tk, to, td) = _rays(jcam, cam, 4, 4, seed=2, sample=0)
    want = jspec.trace_spectral(jscene, jo, jd, jk, max_depth=2)
    got = tspec.trace_spectral(scene, to, td, tk, max_depth=2)
    _close(got, want)
    np.testing.assert_allclose(
        tspec.sample_wavelengths(tk, 16, "cpu").numpy(),
        np.asarray(jspec.sample_wavelengths(jk, 16)), rtol=0, atol=0)


@pytest.mark.parametrize("spectral", [False, True])
def test_render_flat_matches_jax(spectral):
    """The slice as a whole, through the entry point (engine
    "wavefront"): the demo scene at 16x8, spp 2, depth 3; spectrally the
    glass close-up at 4x4, spp 1, depth 2."""
    if spectral:
        jscene, jcam = _glass_closeup()
        kw = dict(width=4, height=4, spp=1, max_depth=2, seed=4)
    else:
        jscene, jcam = st.create_scene(), st.default_camera(2.0)
        kw = dict(width=16, height=8, spp=2, max_depth=3, seed=4)
    scene, cam = _port(jscene, jcam)
    want = j_render_flat(jscene, jcam, spectral=spectral, **kw)
    got = sp.render_flat_engine(scene, cam, engine="wavefront",
                                spectral=spectral, **kw)
    _close(got, want)
    torch.testing.assert_close(
        sp.render_flat(scene, cam, spectral=spectral, **kw), got, rtol=0,
        atol=0)


@pytest.fixture(scope="module")
def packed_mesh():
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=4.0,
                         device="cpu")
    return scene, cam


@pytest.mark.parametrize("grad", [False, True])
def test_hook_accumulate_rows_matches_traversal(packed_mesh, grad):
    """accumulate_rows on a packed mesh with the #3 hook (its plain
    version here) against the same call through intersect_scene (the
    stackless walk of scene.bvh), as JAX holds its sorted hook."""
    scene, cam = packed_mesh
    kw = dict(width=64, height=16, row_start=0, n_rows=16, sample_offset=0,
              n_samples=2, max_depth=3, semantics="physical")
    base = sp.rng.base_key(5)
    before = tbk.intersect_tile.launches
    hook = accumulate_rows(scene, cam, base, intersect_fn=(
        tbk.make_sorted_tile_intersect(grad=grad)), **kw)
    walk = accumulate_rows(scene, cam, base, **kw)
    assert tbk.intersect_tile.launches == before  # CPU: the plain #3
    assert np.isfinite(hook.numpy()).all() and hook.std() > 1e-3
    np.testing.assert_allclose(hook.numpy(), walk.numpy(), rtol=HOOK_RTOL,
                               atol=HOOK_ATOL)


W_GOLD, H_GOLD, SPP_GOLD, DEPTH_GOLD = 24, 14, 96, 4


def test_render_with_cpu_matches_reference_oracle():
    """render_with_cpu (wavefront, reference semantics) of the demo scene
    against the independent scalar oracle, at the size and thresholds of
    the JAX package's golden test."""
    spheres, materials = default_scene()
    ref = CPUReferenceRenderer(spheres, materials,
                               np.random.default_rng(1234))
    oracle = ref.render_hdr(default_camera_dict(W_GOLD / H_GOLD), W_GOLD,
                            H_GOLD, spp=SPP_GOLD, max_depth=DEPTH_GOLD)
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(W_GOLD / H_GOLD, device="cpu")
    img = sp.render_hdr(scene, cam, W_GOLD, H_GOLD, spp=SPP_GOLD,
                        max_depth=DEPTH_GOLD, semantics="reference",
                        engine="wavefront", seed=77).numpy()
    diff = np.abs(img - oracle)
    assert diff.mean() < 0.03, diff.mean()
    assert (diff > 0.25).mean() < 0.02
    np.testing.assert_allclose(img.mean(), oracle.mean(), rtol=0.02)
    out = sp.render_with_cpu(scene, cam, W_GOLD, H_GOLD,
                             samples_per_pixel=2, max_depth=2, seed=77)
    want = sp.render(scene, cam, W_GOLD, H_GOLD, samples_per_pixel=2,
                     max_depth=2, seed=77, semantics="reference",
                     engine="wavefront")
    np.testing.assert_array_equal(out, want)


def test_wavefront_entry_points_on_cpu(packed_mesh):
    """render() routes a mesh scene on the CPU to the wavefront (RGB and
    spectral), render_hybrid_gpu is render(), and the fused engines
    refuse reference semantics."""
    scene, cam = packed_mesh
    kw = dict(samples_per_pixel=1, max_depth=2, seed=3)
    assert sp.select_engine(scene, "physical", False) == "wavefront"
    for spectral in (False, True):
        img = sp.render(scene, cam, 16, 8, spectral=spectral, **kw)
        assert img.shape == (8, 16, 3) and img.dtype == np.uint8
        assert img.std() > 0
    np.testing.assert_array_equal(sp.render_hybrid_gpu(scene, cam, 16, 8,
                                                       **kw),
                                  sp.render(scene, cam, 16, 8, **kw))
    demo = sp.create_scene(device="cpu")
    for engine in ("fused", "cuda", "cuda_bvh"):
        with pytest.raises(ValueError, match="physical semantics only"):
            sp.render(demo, cam, 8, 8, engine=engine, semantics="reference",
                      **kw)
    with pytest.raises(ValueError, match="unknown semantics"):
        sp.render(demo, cam, 8, 8, semantics="bogus", **kw)
    with pytest.raises(ValueError, match="spp"):
        sp.render_flat(demo, cam, width=8, height=8, spp=0)


def test_wavefront_frame_operation_count():
    """bench/wavefront_frame.py's count: one zeroed accumulator a frame,
    then the same operations every sample; the draws are most of them."""
    from spira_tpu_torch.bench import wavefront_frame as wf

    one, two = wf.count_operations(1, 2), wf.count_operations(2, 2)
    assert two["draws"] == 2 * one["draws"] > 0
    assert two["frame"] - one["frame"] == one["frame"] - 1
    assert one["draws"] < one["frame"] < 2 * one["draws"]
