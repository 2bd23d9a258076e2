"""The port's renderers and their configuration against the JAX
package's, on the CPU at small sizes: ``RenderConfig`` and
``build_scene``, the row-set and block-set raygen,
``accumulate_row_set`` / ``accumulate_block_set``, the preview renderer,
the progressive renderer with its checkpoints, and the adaptive
renderer.

Tolerances, stated beside each test: the draws are JAX's threefry bits,
so the paths are JAX's, but a transcendental or a sum that differs in its
last bit may flip a branch and move a whole path; so estimates are held
as ``tests/test_torch_wavefront_trace.py`` holds them (at least 99% of
rays within rtol 1e-4 / atol 1e-5, channel means within 1e-4 relative).
The adaptive renderer's retirement decisions come from float statistics,
so its schedule is held statistically against JAX's, never bit for bit;
against itself the port is deterministic and its resumes are exact to the
bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu import pipeline as jpipe
from spira_tpu.core import rng as jr
from spira_tpu.integrator.preview import render_flat_preview as j_preview
from spira_tpu.render import accumulate_block_set as j_block_set
from spira_tpu.render import accumulate_row_set as j_row_set
from spira_tpu.render import render_hdr as j_render_hdr
from spira_tpu.scene.camera import generate_rays as j_generate_rays
from spira_tpu.utils import checkpoint as jckpt
from spira_tpu.utils import config as jconfig
from spira_tpu_torch import pipeline
from spira_tpu_torch.integrator.preview import render_flat_preview
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.io.image import load_exr
from spira_tpu_torch.render import (
    ENGINES,
    LUMA,
    accumulate_block_set,
    accumulate_row_set,
)
from spira_tpu_torch.utils import checkpoint as ckpt
from spira_tpu_torch.utils import config
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL, FRAC, MEAN_REL = 1e-4, 1e-5, 0.99, 1e-4


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _close(got, want):
    """Estimates (rows of the last axis, or scalars): the share of rows
    within RTOL / ATOL, and the means."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    near = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    frac = (near.all(-1) if got.ndim > 1 else near).mean()
    assert frac >= FRAC, frac
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)


def tiny_cfg(**kw):
    base = dict(width=24, height=16, spp=4, max_depth=2, progress=False,
                output="", device="cpu")
    base.update(kw)
    return config.RenderConfig(**base)


def _jax_cfg(cfg):
    d = json.loads(cfg.to_json())
    d.pop("device")
    return jconfig.RenderConfig.from_json(json.dumps(d))


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def test_config_json_round_trip_and_jax_form():
    """The JSON round trip, and the JSON is JAX's plus ``device``: JAX's
    config JSON counts as the same render on any device."""
    cfg = tiny_cfg(scene="cornell", spectral=True, lookfrom=(1, 2, 3),
                   adaptive_tol=0.05)
    assert config.RenderConfig.from_json(cfg.to_json()) == cfg
    mine = json.loads(cfg.to_json())
    assert mine.pop("device") == "cpu"
    jcfg = _jax_cfg(cfg)
    assert mine == json.loads(jcfg.to_json())
    assert config.same_render(jcfg.to_json(), cfg)
    assert config.same_render(cfg.to_json(),
                              tiny_cfg(scene="cornell", spectral=True,
                                       lookfrom=(1, 2, 3), adaptive_tol=0.05,
                                       device="cuda"))
    assert not config.same_render(jcfg.to_json(), tiny_cfg(spp=5))
    assert {f for f in config.RenderConfig.__dataclass_fields__} == \
        set(jconfig.RenderConfig.__dataclass_fields__) | {"device"}


def test_presets_and_engine_choices():
    assert config.PRESETS == jconfig.PRESETS
    assert config.ENGINE_CHOICES == ("auto",) + ENGINES


def test_cli_flags_map_to_presets():
    """``tests/test_pipeline.py``'s preset rules, and ``--device``."""
    import argparse

    p = argparse.ArgumentParser()
    config.add_render_args(p)
    cfg = config.config_from_args(p.parse_args(["--preset", "quality"]))
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == \
        (1280, 720, 100, 10)
    assert cfg.device == "cuda"
    cfg = config.config_from_args(p.parse_args(["--preset", "demo",
                                                "--width=800"]))
    assert (cfg.width, cfg.height) == (800, 360)
    cfg = config.config_from_args(p.parse_args(["--preset", "quick", "--wid",
                                                "99", "--device", "cpu"]))
    assert (cfg.width, cfg.height, cfg.device) == (99, 180, "cpu")
    cfg = config.config_from_args(p.parse_args([]))
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (640, 360, 32, 4)
    with pytest.raises(SystemExit):
        p.parse_args(["--device", "tpu"])


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_build_scene_matches_jax(name):
    """The same scene and camera values as JAX's ``build_scene`` on the
    same config (camera within 1e-6: ``tan`` may round differently)."""
    cfg = tiny_cfg(scene=name, lookfrom=(0.5, 1.0, 3.0), vfov=50.0)
    scene, cam = config.build_scene(cfg)
    jscene, jcam = jconfig.build_scene(_jax_cfg(cfg))
    assert scene.device.type == "cpu"
    for group in ("spheres", "triangles", "materials"):
        for field, value in vars(getattr(jscene, group)).items():
            if isinstance(value, jax.Array):
                np.testing.assert_array_equal(
                    getattr(getattr(scene, group), field).numpy(),
                    np.asarray(value), err_msg=f"{group}.{field}")
    for field in ("origin", "lower_left_corner", "horizontal", "vertical",
                  "u", "v", "lens_radius"):
        np.testing.assert_allclose(getattr(cam, field).numpy(),
                                   np.asarray(getattr(jcam, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


def test_build_scene_packs_for_the_port_engines():
    """Pair tables at build time for every engine that feeds on them
    (JAX's conditions, the port's names); the progressive renderer and the
    wavefront skip them; unknown scenes raise."""
    for engine, spectral in [("bvh_sorted", False),
                             ("cuda_spectral_bvh", True), ("auto", True),
                             ("cuda_bvh", False)]:
        scene, _ = config.build_scene(tiny_cfg(scene="mesh", engine=engine,
                                               spectral=spectral))
        assert scene.packed is not None, engine
    for kw in (dict(engine="wavefront"), dict(checkpoint_every=2),
               dict(semantics="reference")):
        scene, _ = config.build_scene(tiny_cfg(scene="mesh", **kw))
        assert scene.packed is None and scene.bvh is not None, kw
    with pytest.raises(ValueError):
        config.build_scene(tiny_cfg(scene="nope"))


def test_build_scene_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.build_scene(tiny_cfg(device="cuda"))


# ---------------------------------------------------------------------------
# Raygen over row and block sets
# ---------------------------------------------------------------------------

def _keys(seed, sample):
    return (jr.sample_key(jr.base_key(seed), sample),
            sp.rng.sample_key(sp.rng.base_key(seed), sample))


def test_set_raygen_matches_contiguous_rows():
    """``rows=arange(4, 12)`` and the blocks that tile those rows are the
    contiguous rows 4..11 to the bit (JAX's
    ``test_row_set_raygen_matches_contiguous``)."""
    cam = sp.default_camera(2.0, device="cpu")
    key = _keys(7, 3)[1]
    o1, d1 = sp.generate_rays(cam, 256, 16, key, row_start=4, n_rows=8)
    o2, d2 = sp.generate_rays(cam, 256, 16, key, rows=torch.arange(4, 12))
    o3, d3 = sp.generate_rays(cam, 256, 16, key,
                              blocks=list(range(4 * 2, 12 * 2)))
    for o, d in ((o2, d2), (o3, d3)):
        assert torch.equal(o, o1) and torch.equal(d, d1)
    with pytest.raises(ValueError, match="width % 128"):
        sp.generate_rays(cam, 200, 16, key, blocks=[0])


@pytest.mark.parametrize("form", ["rows", "blocks"])
def test_set_raygen_matches_jax(form):
    """Against JAX's ``rows=``/``blocks=`` raygen on a thin-lens camera:
    the same jitter and lens bits (a ray's draws depend only on its
    position), directions within 1e-6."""
    jcam = st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=2.0, aperture=0.2, focus_dist=3.0)
    cam = sp.camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam),
                               device="cpu")
    ids = np.asarray([5, 0, 13, 2, 9] if form == "blocks" else [7, 1, 3],
                     np.int32)
    jk, tk = _keys(11, 2)
    jo, jd = j_generate_rays(jcam, 256, 8, jk, **{form: jnp.asarray(ids)})
    o, d = sp.generate_rays(cam, 256, 8, tk, **{form: torch.from_numpy(ids)})
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# accumulate_row_set / accumulate_block_set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["rows", "blocks"])
def test_accumulate_sets_match_jax(form):
    """128x6 demo, depth 2, 2 samples from sample base 5, on a set of rows
    or blocks: the radiance sum and the luminance sums on the statistical
    contract."""
    jscene, jcam = st.create_scene(), st.default_camera(128 / 6)
    scene, cam = _port(jscene, jcam)
    ids = np.asarray([4, 0, 2], np.int32)
    kw = dict(width=128, height=6, n_samples=2, max_depth=2)
    jfn, fn = ((j_row_set, accumulate_row_set) if form == "rows"
               else (j_block_set, accumulate_block_set))
    want = jfn(jscene, jcam, jr.base_key(3), jnp.asarray(ids),
               jnp.int32(5), **kw)
    got = fn(scene, cam, sp.rng.base_key(3), torch.from_numpy(ids), 5, **kw)
    assert got[0].shape == (3 * 128, 3)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(
        got[1].numpy(), got[0].numpy() @ np.asarray(LUMA, np.float32),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Preview
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shading", ["preview", "normal"])
@pytest.mark.parametrize("name", ["demo", "cornell"])
def test_preview_matches_jax(name, shading):
    """``render_flat_preview`` against JAX's at 32x16: mean abs difference
    at most 1e-5, at most 0.1% of pixels differing by more than 1e-4."""
    if name == "demo":
        jscene, jcam = st.create_scene(), st.default_camera(2.0)
    else:
        jscene, jcam = st.create_cornell_box(), st.cornell_camera(2.0)
    scene, cam = _port(jscene, jcam)
    want = np.asarray(j_preview(jscene, jcam, width=32, height=16, seed=4,
                                shading=shading))
    got = render_flat_preview(scene, cam, width=32, height=16, seed=4,
                              shading=shading).numpy()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-5
    assert (diff.max(-1) > 1e-4).mean() <= 1e-3
    img = sp.render(scene, cam, 32, 16, seed=4, shading=shading)
    assert img.shape == (16, 32, 3) and img.std() > 1.0


def test_preview_through_the_packed_hook():
    """On a packed mesh scene the preview through the packed-BVH hook
    (the plain query on the CPU; kernel #3 on the card) against the
    scene's own traversal: the primary-hit tolerance of the hook tests
    (rtol 1e-3 / atol 1e-4 on 99.9% of pixels)."""
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device="cpu")
    for shading in ("preview", "normal"):
        kw = dict(width=32, height=16, seed=1, shading=shading)
        hooked = render_flat_preview(
            scene, cam, intersect_fn=tbk.make_sorted_tile_intersect(), **kw)
        walked = render_flat_preview(scene, cam, **kw)  # CPU: the traversal
        near = np.isclose(hooked.numpy(), walked.numpy(), rtol=1e-3,
                          atol=1e-4).all(-1)
        assert near.mean() >= 0.999 and walked.std() > 0.01


# ---------------------------------------------------------------------------
# The progressive renderer
# ---------------------------------------------------------------------------

def test_progressive_equals_single_shot():
    """Chunks of 2 add their samples to the sum so far in sample order, so
    the render in chunks is ``render_flat``'s to the bit."""
    cfg = tiny_cfg(spp=6, checkpoint_every=2)
    scene, cam = config.build_scene(cfg)
    chunked = pipeline.render_progressive(scene, cam, cfg)
    single = sp.render_hdr(scene, cam, cfg.width, cfg.height, spp=6,
                           max_depth=2, engine="wavefront").numpy()
    np.testing.assert_array_equal(chunked, single)


class _Preempted(Exception):
    pass


def test_progressive_chunk_that_raises_keeps_the_last_checkpoint(
        tmp_path, monkeypatch):
    """The third chunk raises: the checkpoint holds the second chunk's
    4 samples (JAX's renderer loses them: its save of chunk 2 waits behind
    chunk 3's launch, ``spira_tpu/pipeline.py:134``), and the resume is
    the uninterrupted render to the bit."""
    ckdir = str(tmp_path / "ck")
    cfg = tiny_cfg(spp=8, checkpoint_every=2, checkpoint_dir=ckdir)
    scene, cam = config.build_scene(cfg)
    chunk = pipeline._render_chunk
    calls = []

    def flaky(*args, **kw):
        calls.append(kw["n_samples"])
        if len(calls) == 3:
            raise _Preempted
        return chunk(*args, **kw)

    monkeypatch.setattr(pipeline, "_render_chunk", flaky)
    with pytest.raises(_Preempted):
        pipeline.render_progressive(scene, cam, cfg)
    assert ckpt.load_render_state(ckdir)[1] == 4
    monkeypatch.setattr(pipeline, "_render_chunk", chunk)
    resumed = pipeline.render_progressive(scene, cam, cfg)
    fresh = pipeline.render_progressive(scene, cam, tiny_cfg(
        spp=8, checkpoint_every=2))
    np.testing.assert_array_equal(resumed, fresh)


def test_progressive_config_mismatch_restarts(tmp_path):
    ckdir = str(tmp_path / "ck2")
    cfg = tiny_cfg(spp=4, checkpoint_dir=ckdir, checkpoint_every=2)
    scene, cam = config.build_scene(cfg)
    for seed, cfg_json in ((99, cfg.to_json()),
                           (0, tiny_cfg(spp=4, seed=3).to_json())):
        ckpt.save_render_state(
            ckdir, accumulator=np.full((24 * 16, 3), 7.0, np.float32),
            samples_done=2, seed=seed, config_json=cfg_json)
        out = pipeline.render_progressive(scene, cam, cfg)
        fresh = pipeline.render_progressive(scene, cam, tiny_cfg(spp=4))
        np.testing.assert_array_equal(out, fresh)


def test_progressive_resumes_a_jax_checkpoint(tmp_path):
    """A partial render that the JAX package saved (its
    ``save_render_state`` over its ``_render_chunk``, 2 of 6 samples)
    resumes in the port and ends as JAX's one-shot wavefront render, on
    the statistical contract."""
    ckdir = str(tmp_path / "jax_ck")
    cfg = tiny_cfg(spp=6, checkpoint_every=2, checkpoint_dir=ckdir)
    jcfg = _jax_cfg(cfg)
    jscene, jcam = jconfig.build_scene(jcfg)
    acc = jpipe._render_chunk(
        jscene, jcam, jnp.int32(0), width=cfg.width, height=cfg.height,
        n_samples=2, max_depth=cfg.max_depth, semantics=cfg.semantics,
        spectral=False, seed=cfg.seed)
    jckpt.save_render_state(ckdir, accumulator=acc, samples_done=2,
                            seed=cfg.seed, config_json=jcfg.to_json())
    scene, cam = _port(jscene, jcam)
    resumed = pipeline.render_progressive(scene, cam, cfg)
    want = np.asarray(j_render_hdr(jscene, jcam, cfg.width, cfg.height,
                                   spp=6, max_depth=2, engine="wavefront"))
    _close(resumed.reshape(-1, 3), want.reshape(-1, 3))


def test_progressive_refuses_a_mesh():
    """The progressive renderer under a mesh of one rank (no process
    group) with a chunk of the whole spp is the one-shot wavefront render
    to the bit, and in chunks of 2 the chunks' sums added in sample order
    (JAX's ``acc + part``) within float-sum order; ``run_config(n_tile=1)``
    is the tone-mapped sharded frame.  A mesh larger than the world raises
    ``ValueError``, as JAX's ``make_mesh`` does."""
    from spira_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, device="cpu")
    cfg = tiny_cfg()
    scene, cam = config.build_scene(cfg)
    want = sp.render_hdr(scene, cam, cfg.width, cfg.height, spp=cfg.spp,
                         max_depth=cfg.max_depth, engine="wavefront").numpy()
    whole = pipeline.render_progressive(scene, cam, cfg, mesh=mesh)
    np.testing.assert_array_equal(whole, want)
    chunked = pipeline.render_progressive(
        scene, cam, tiny_cfg(checkpoint_every=2), mesh=mesh)
    np.testing.assert_allclose(chunked, want, rtol=0, atol=4e-6 * want.max())
    out = pipeline.run_config(tiny_cfg(n_tile=1))
    np.testing.assert_array_equal(out, pipeline._tonemap(cfg, want))
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pipeline.run_config(tiny_cfg(n_tile=2))


# ---------------------------------------------------------------------------
# The adaptive renderer
# ---------------------------------------------------------------------------

def _adaptive_demo(w, h, spp, **kw):
    cfg = tiny_cfg(width=w, height=h, spp=spp, max_depth=3, **kw)
    scene, cam = config.build_scene(cfg)
    return scene, cam, cfg


def test_adaptive_saves_samples_and_sky_rows_retire_first():
    """JAX's ``test_adaptive_saves_samples_and_sky_rows_retire_first`` at
    64x48: the sky rows converge first; one host sync a round."""
    scene, cam, cfg = _adaptive_demo(64, 48, 16)
    img, stats = pipeline.render_adaptive(scene, cam, cfg, tol=0.05,
                                          min_spp=4, chunk=4,
                                          return_stats=True)
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    assert stats["savings"] > 0.1
    spp = stats["spp_per_row"]  # top-down
    assert spp[:8].mean() < spp[-8:].mean()
    assert spp.min() >= 4 and spp.max() <= cfg.spp
    assert stats["host_syncs"] == stats["rounds"] <= cfg.spp // 4


def test_adaptive_is_deterministic_and_resumes_exactly(tmp_path):
    """Two runs agree to the bit; a run that resumes from a mid-flight
    round's checkpoint ends the same to the bit; a hyperparameter
    mismatch starts afresh."""
    ckdir = str(tmp_path / "ck")
    scene, cam, cfg = _adaptive_demo(128, 16, 12, checkpoint_dir=ckdir)
    kw = dict(tol=0.03, min_spp=4, chunk=4, granularity="block")
    plain = tiny_cfg(width=128, height=16, spp=12, max_depth=3)
    a = pipeline.render_adaptive(scene, cam, plain, **kw)
    b = pipeline.render_adaptive(scene, cam, plain, **kw)
    np.testing.assert_array_equal(a, b)
    full = pipeline.render_adaptive(scene, cam, cfg, **kw)
    np.testing.assert_array_equal(full, a)
    state = ckpt.load_adaptive_state(ckdir)
    assert state is not None and state[1]["spp_done"] < 12
    resumed = pipeline.render_adaptive(scene, cam, cfg, **kw)
    np.testing.assert_array_equal(resumed, full)
    fresh = pipeline.render_adaptive(scene, cam, cfg, tol=0.03, min_spp=4,
                                     chunk=2, granularity="block")
    assert np.isfinite(fresh).all() and not np.array_equal(fresh, full)


@pytest.mark.parametrize("granularity,tol", [("block", 0.02), ("row", 0.1)])
def test_adaptive_schedule_matches_jax(granularity, tol):
    """The port's adaptive render against JAX's on the same scene, config
    and hyperparameters (128x8, spp cap 8, chunk 2; tolerances at which
    segments retire at 2, 6 and 8 spp): at least 80% of the segments
    retire at the same spp, the per-segment spp maps' means within 10%,
    the image means within 2% and the RMSE between the two images below a
    quarter of the image's mean."""
    scene, cam, cfg = _adaptive_demo(128, 8, 8)
    jscene, jcam = jconfig.build_scene(_jax_cfg(cfg))
    kw = dict(tol=tol, min_spp=2, chunk=2, granularity=granularity,
              return_stats=True)
    img, stats = pipeline.render_adaptive(scene, cam, cfg, **kw)
    jimg, jstats = jpipe.render_adaptive(jscene, jcam, _jax_cfg(cfg), **kw)
    assert len(np.unique(jstats["spp_map"])) >= 2
    same = (stats["spp_map"] == jstats["spp_map"]).mean()
    assert same >= 0.8, same
    np.testing.assert_allclose(stats["spp_map"].mean(),
                               jstats["spp_map"].mean(), rtol=0.1)
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=0.02)
    assert np.sqrt(np.mean((img - jimg) ** 2)) < 0.25 * jimg.mean()


def test_adaptive_mesh_scene_through_the_packed_hook():
    """On a packed mesh scene every bounce's nearest hit through the
    packed-BVH hook (the plain query on the CPU): deterministic, and the
    uniform wavefront render's statistics (RMSE below 0.35, JAX's bound
    at spp <= 8)."""
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device="cpu")
    cfg = tiny_cfg(width=32, height=16, spp=8, max_depth=2)
    hook = tbk.make_sorted_tile_intersect()
    kw = dict(tol=0.1, min_spp=2, chunk=2, intersect_fn=hook)
    a = pipeline.render_adaptive(scene, cam, cfg, **kw)
    b = pipeline.render_adaptive(scene, cam, cfg, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.std() > 1e-3
    un = sp.render_hdr(scene, cam, 32, 16, spp=8, max_depth=2,
                       engine="wavefront").numpy()
    assert np.sqrt(np.mean((a - un) ** 2)) < 0.35


def test_run_config_dispatch(tmp_path):
    """``run_config`` writes the render, the adaptive render and the
    preview at the configured size."""
    from PIL import Image

    for i, kw in enumerate((dict(), dict(adaptive_tol=0.1,
                                         adaptive_min_spp=2),
                            dict(shading="normal"),
                            dict(checkpoint_every=2, tonemap="aces"))):
        out = str(tmp_path / f"r{i}.png")
        img = pipeline.run_config(tiny_cfg(width=48, height=32, output=out,
                                           **kw))
        assert img.shape == (32, 48, 3) and img.dtype == np.uint8
        assert Image.open(out).size == (48, 32)
    hdr_path = str(tmp_path / "r.exr")
    pipeline.run_config(tiny_cfg(output=hdr_path))
    assert load_exr(hdr_path).shape == (16, 24, 3)
