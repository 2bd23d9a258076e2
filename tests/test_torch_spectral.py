"""The port's spectral slice against the JAX package: the SPD tables of
``make_materials`` and the converter, the spectral packers, the plain
spectral tracers against ``render_flat_fused_spectral`` (fused XLA) and
``render_flat_spectral_bvh_megakernel`` (Pallas, ``interpret=True``), and
the spectral routing of ``render``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel.bvh import build_bvh_for_triangles as j_build_bvh
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.kernels import spectral_bvh as jsb
from spira_tpu.kernels import spectral_fused as jsf
from spira_tpu.scene import geometry as jgeo
from spira_tpu.scene import materials as jmat
from spira_tpu.scene import obj as jobj
from spira_tpu.scene import scene as jscn
from spira_tpu_torch.accel.bvh import build_bvh_for_triangles
from spira_tpu_torch.kernels import megakernel as tmk
from spira_tpu_torch.kernels import spectral_bvh as tsb
from spira_tpu_torch.kernels import spectral_fused as tsf
from spira_tpu_torch.scene.geometry import empty_spheres
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

#: whole images: channel means within 0.5%, 99% of pixel-channels within
#: 1e-4 (a transcendental that differs in its last bit moves a whole path)
MEAN_REL, PIX_ATOL, PIX_FRAC = 0.005, 1e-4, 0.99
#: the Chebyshev fit is a float32 einsum of 24 terms, summed in an order
#: XLA and torch may not share; its rounding error scales with the SPD's
#: size (the Cornell light's flat emission of 15 moves its small high
#: coefficients by 2.6e-6), so the absolute limit is per unit of the table
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6


def _to_port(jscene, jcam=None):
    as_np = jax.tree_util.tree_map(np.asarray, jscene)
    scene = sp.scene_from_numpy(as_np, device="cpu")
    if jcam is None:
        return scene
    return scene, sp.camera_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcam), device="cpu")


def _assert_fit_close(got, want, materials):
    scale = max(1.0, float(materials.albedo_spd.abs().max()),
                float(materials.emission_spd.abs().max()))
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL,
                               atol=FIT_ATOL * scale)


def _assert_images_agree(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.std() > 1e-3
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= PIX_ATOL).mean() >= PIX_FRAC


def _dispersive_records():
    """Ground, light, a 0.5-radius dispersive glass sphere in view (the
    specular lobe always, so it refracts), a red ball behind it."""
    materials = [
        dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
        dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0, ior=1.5,
             transmission=1.0, cauchy_b=0.01),
        dict(albedo=(0.8, 0.1, 0.1), metallic=0.0, roughness=0.5),
    ]
    spheres = [
        ((0.0, -100.5, 0.0), 100.0, 0),
        ((0.0, 5.0, 0.0), 1.0, 1),
        ((0.0, 0.0, 0.0), 0.5, 2),
        ((0.4, -0.2, -1.2), 0.3, 3),
    ]
    return materials, spheres


def _icosphere_records():
    """The scene of tests/test_spectral_bvh.py: a 20-triangle icosphere
    over a ground sphere, a light, and a dispersive sphere."""
    materials = [
        dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
        dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
        dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        dict(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=0.0, ior=1.5,
             transmission=1.0, cauchy_b=0.01),
    ]
    spheres = [
        ((0.0, -100.5, 0.0), 100.0, 1),
        ((0.0, 5.0, 0.0), 1.0, 2),
        ((1.1, 0.0, 0.4), 0.35, 3),
    ]
    return materials, spheres


_TETRA = ([(0.0, 0.9, 0.0), (-0.55, 0.05, 0.35), (0.55, 0.05, 0.35),
           (0.0, 0.05, -0.6)],
          [(0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2)])


def _tetra(material):
    return sp.make_triangles(*_TETRA, material=material, device="cpu")


def _port_mesh_scene(mesh):
    materials, spheres = _icosphere_records()
    return sp.attach_packed(sp.make_scene(
        spheres=sp.make_spheres(spheres, device="cpu"), triangles=mesh,
        materials=sp.make_materials(materials, device="cpu"),
        bvh=build_bvh_for_triangles(mesh)))


def _mesh_camera(width, height):
    return sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=width / height, device="cpu")


# ---------------------------------------------------------------------------
# The repairs: SPD tables in make_materials and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_fn", ["create_scene", "create_cornell_box",
                                      "create_mesh_scene"])
def test_make_materials_spd_tables_match_jax(scene_fn):
    kw = dict(subdivisions=1) if scene_fn == "create_mesh_scene" else {}
    want = getattr(st, scene_fn)(**kw).materials
    got = getattr(sp, scene_fn)(**kw, device="cpu").materials
    for name in ("albedo_spd", "emission_spd"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_make_materials_record_spd_wins():
    spd = np.linspace(0.1, 0.9, 24).astype(np.float32)
    records = [dict(albedo=(0.5, 0.2, 0.1), albedo_spd=spd),
               dict(albedo=(1.0, 1.0, 1.0), emission=(2.0, 1.0, 0.5),
                    emission_spd=2.0 * spd)]
    got = sp.make_materials(records, device="cpu")
    want = jmat.make_materials(records)
    np.testing.assert_array_equal(got.albedo_spd[0].numpy(), spd)
    np.testing.assert_array_equal(got.emission_spd[1].numpy(), 2.0 * spd)
    for name in ("albedo_spd", "emission_spd"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_scene_from_numpy_carries_spd_tables():
    jscene = st.create_cornell_box()
    scene = _to_port(jscene)
    for name in ("albedo_spd", "emission_spd"):
        np.testing.assert_array_equal(
            getattr(scene.materials, name).numpy(),
            np.asarray(getattr(jscene.materials, name)), err_msg=name)
    bare = jax.tree_util.tree_map(np.asarray, jscene)
    bare = dataclasses.replace(bare, materials=dataclasses.replace(
        bare.materials, albedo_spd=None, emission_spd=None))
    got = sp.scene_from_numpy(bare, device="cpu").materials
    assert got.albedo_spd is None and got.emission_spd is None


# ---------------------------------------------------------------------------
# Host side: the spectral tables
# ---------------------------------------------------------------------------

def test_host_constants_match_jax():
    assert (tsf.N_SPH_SPEC, tsf.N_TRI_SPEC, tsf.N_MAT_SPEC) == (
        jsf.N_SPH_SPEC, jsf.N_TRI_SPEC, jsb.N_MAT_SPEC) == (33, 41, 29)
    np.testing.assert_array_equal(tsf._CHEB_PINV, jsf._CHEB_PINV)
    for name in ("_SKY_WHITE", "_SKY_CYAN", "_SKY_BLUE"):
        np.testing.assert_array_equal(
            np.asarray(getattr(tsf, name), np.float32),
            np.asarray(getattr(jsf, name), np.float32), err_msg=name)
    x = np.linspace(-1.0, 1.0, 97).astype(np.float32)
    np.testing.assert_allclose(
        tsf._cheb(tsf._SKY_CYAN, torch.from_numpy(x)).numpy(),
        np.asarray(jsf._cheb(jsf._SKY_CYAN, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scene_fn", ["create_scene", "create_cornell_box"])
def test_pack_scene_spectral_matches_jax(scene_fn):
    jscene = getattr(st, scene_fn)()
    for scene in (_to_port(jscene), getattr(sp, scene_fn)(device="cpu")):
        sph, tri = tsf.pack_scene_spectral(scene)
        jsph, jtri = jsf.pack_scene_spectral_jnp(jscene)
        _assert_fit_close(sph.numpy(), np.asarray(jsph), scene.materials)
        if scene.triangles.count:
            _assert_fit_close(tri.numpy(), np.asarray(jtri),
                              scene.materials)
        else:  # JAX pads one row that no kernel reads
            assert tri.shape == (0, tsf.N_TRI_SPEC)


def test_pack_materials_spectral_matches_jax():
    jscene = st.create_cornell_box()
    materials = _to_port(jscene).materials
    got = tsf.pack_materials_spectral(materials)
    want = jsb.pack_materials_spectral_jnp(jscene.materials)
    _assert_fit_close(got.numpy(), np.asarray(want), materials)
    # every record carries the material record at its offset
    sph, tri = tsf.pack_scene_spectral(_to_port(jscene))
    mid = _to_port(jscene).triangles.material.long()
    torch.testing.assert_close(tri[:, 12:], got[mid], rtol=0, atol=0)
    mid = _to_port(jscene).spheres.material.long()
    torch.testing.assert_close(sph[:, 4:], got[mid], rtol=0, atol=0)


def test_pack_materials_spectral_needs_tables():
    mats = sp.create_scene(device="cpu").materials
    bare = dataclasses.replace(mats, albedo_spd=None)
    with pytest.raises(ValueError, match="albedo_spd"):
        tsf.pack_materials_spectral(bare)


# ---------------------------------------------------------------------------
# The plain spectral tracers against JAX
# ---------------------------------------------------------------------------

def test_fused_spectral_matches_jax_demo():
    """create_scene() at 32x16, spp 4, depth 3, seed 3."""
    w, h = 32, 16
    jscene, jcam = st.create_scene(), st.default_camera(w / h)
    scene, cam = _to_port(jscene, jcam)
    kw = dict(width=w, height=h, spp=4, max_depth=3, seed=3)
    want = np.asarray(jsf.render_flat_fused_spectral(jscene, jcam, **kw))
    got = tsf.render_flat_fused_spectral(scene, cam, **kw).numpy()
    _assert_images_agree(got, want)


def _glass_pixels(scene, cam, width, height):
    """Pixels whose pixel-centre primary ray first hits a dispersive
    material."""
    cam_t = tmk.cam_tuple(tmk.pack_camera(cam), cam.has_lens)
    pixel = torch.arange(width * height)
    u = ((pixel % width).float() + 0.5) / (width - 1)
    v = ((pixel // width).float() + 0.5) / (height - 1)
    (ox, oy, oz, lx, ly, lz, hx, hy, hz, vx, vy, vz) = cam_t[:12]
    d = tmk._norm3(lx + u * hx + v * vx - ox, ly + u * hy + v * vy - oy,
                   lz + u * hz + v * vz - oz)
    o = tuple(torch.zeros_like(u) + c for c in (ox, oy, oz))
    sph, tri = tsf.pack_scene_spectral(scene)
    hit, _, _, mat = tsf.make_brute_intersect_spectral(sph, tri)(o, d)
    return int((hit & (mat[:, 4] > 0.0)).sum())


def test_fused_spectral_matches_jax_dispersive_depth6():
    """A spheres-only scene with a dispersive glass sphere in view at
    32x16, spp 4, depth 6, seed 3: the hero collapse and Russian roulette
    (bounces past the fourth) both run."""
    w, h = 32, 16
    materials, spheres = _dispersive_records()
    jscene = jscn.make_scene(spheres=jgeo.make_spheres(spheres),
                             materials=jmat.make_materials(materials))
    jcam = st.default_camera(w / h)
    scene, cam = _to_port(jscene, jcam)
    assert _glass_pixels(scene, cam, w, h) >= 10
    kw = dict(width=w, height=h, spp=4, max_depth=6, seed=3)
    want = np.asarray(jsf.render_flat_fused_spectral(jscene, jcam, **kw))
    got = tsf.render_flat_fused_spectral(scene, cam, **kw).numpy()
    _assert_images_agree(got, want)
    # the port's own scene builders give the same tables
    own = sp.make_scene(spheres=sp.make_spheres(spheres, device="cpu"),
                        materials=sp.make_materials(materials, device="cpu"))
    for a, b in zip(tsf.pack_scene_spectral(own),
                    tsf.pack_scene_spectral(scene)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_icosphere_scene(w, h):
    """The icosphere scene, packed, and its camera, in JAX."""
    materials, spheres = _icosphere_records()
    mesh = jobj.icosphere(center=(0.0, 0.3, 0.0), radius=0.6,
                          subdivisions=0, material=0)
    jscene = j_attach_packed(jscn.make_scene(
        spheres=jgeo.make_spheres(spheres), triangles=mesh,
        materials=jmat.make_materials(materials), bvh=j_build_bvh(mesh)))
    jcam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          aspect_ratio=w / h)
    return jscene, jcam


def test_spectral_bvh_matches_jax_kernel():
    """The plain spectral BVH render against JAX
    ``render_flat_spectral_bvh_megakernel`` (interpret mode) on the
    icosphere scene at 128x8, spp 1, depth 2, seed 7."""
    w, h = 128, 8
    jscene, jcam = _jax_icosphere_scene(w, h)
    scene, cam = _to_port(jscene, jcam)
    kw = dict(width=w, height=h, spp=1, max_depth=2, seed=7)
    want = np.asarray(jsb.render_flat_spectral_bvh_megakernel(
        jscene, jcam, interpret=True, tile_h=8, **kw))
    got = tsb.render_flat_spectral_bvh_fused(scene, cam, **kw).numpy()
    _assert_images_agree(got, want)


@pytest.mark.parametrize("tracer", ["spheres", "bvh"])
def test_spectral_exclusive_uv_matches_jax(tracer):
    """``inclusive_uv=False`` (u = col / W, v = row / H, not col / (W - 1),
    row / (H - 1)) at spp 1, depth 2, seed 5, limits as above: the sphere
    tracer on ``create_scene()`` at 16x8 against JAX
    ``render_flat_fused_spectral``, and the BVH tracer on the icosphere
    scene at 128x8 (the JAX kernel's tile is 128 pixels wide) against JAX
    ``render_flat_spectral_bvh_megakernel`` in interpret mode."""
    kw = dict(spp=1, max_depth=2, seed=5, inclusive_uv=False)
    if tracer == "spheres":
        w, h = 16, 8
        jscene, jcam = st.create_scene(), st.default_camera(w / h)
        want = jsf.render_flat_fused_spectral(jscene, jcam, width=w,
                                              height=h, **kw)
        plain = tsf.render_flat_fused_spectral
    else:
        w, h = 128, 8
        jscene, jcam = _jax_icosphere_scene(w, h)
        want = jsb.render_flat_spectral_bvh_megakernel(
            jscene, jcam, width=w, height=h, interpret=True, tile_h=8, **kw)
        plain = tsb.render_flat_spectral_bvh_fused
    scene, cam = _to_port(jscene, jcam)
    got = plain(scene, cam, width=w, height=h, **kw).numpy()
    _assert_images_agree(got, np.asarray(want))
    # the flag reaches the tracer: the inclusive image differs
    kw["inclusive_uv"] = True
    assert not np.array_equal(got, plain(scene, cam, width=w, height=h,
                                         **kw).numpy())


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

def test_spectral_bvh_equals_brute_on_tetra():
    """The plain BVH path and the plain brute path give the same image on
    a scene both hold (the same tracer, streams and hits)."""
    scene = _port_mesh_scene(_tetra(0))
    cam = _mesh_camera(128, 8)
    kw = dict(width=128, height=8, spp=2, max_depth=6, seed=7)
    bvh = tsb.render_flat_spectral_bvh_fused(scene, cam, **kw)
    brute = tsf.render_flat_fused_spectral(scene, cam, **kw)
    assert bvh.std() > 1e-3
    torch.testing.assert_close(bvh, brute, rtol=0, atol=1e-5)


def test_spectral_bvh_without_spheres():
    """A packed scene with no spheres renders, and equals the brute path."""
    scene = _port_mesh_scene(_tetra(2))
    scene = dataclasses.replace(scene, spheres=empty_spheres("cpu"))
    cam = _mesh_camera(32, 8)
    kw = dict(width=32, height=8, spp=1, max_depth=3, seed=1)
    got = tsb.render_flat_spectral_bvh_megakernel(scene, cam, **kw)
    assert got.shape == (32 * 8, 3) and torch.isfinite(got).all()
    torch.testing.assert_close(
        got, tsf.render_flat_fused_spectral(scene, cam, **kw), rtol=0,
        atol=1e-5)


def test_spectral_differs_from_rgb():
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    kw = dict(width=32, height=16, spp=2, max_depth=3, seed=0)
    rgb = tmk.render_flat_fused(scene, cam, **kw)
    spec = tsf.render_flat_fused_spectral(scene, cam, **kw)
    assert (rgb - spec).abs().max() > 1e-2
    # the same scene in both: close in the mean, though not equal
    np.testing.assert_allclose(spec.mean(0).numpy(), rgb.mean(0).numpy(),
                               rtol=0.15)


# ---------------------------------------------------------------------------
# Routing through render() and the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_render_spectral_small_scene_on_cpu():
    """spectral=True on a CPU small scene runs the plain spectral tracer,
    under 'auto' ('fused') and under 'cuda' (its plain version); no kernel
    is launched."""
    scene = sp.create_cornell_box(device="cpu")
    cam = sp.cornell_camera(2.0, device="cpu")
    kw = dict(spp=1, max_depth=2, seed=4)
    want = tsf.render_flat_fused_spectral(scene, cam, width=16, height=8,
                                          **kw)
    assert sp.select_engine(scene, "physical", True) == "fused"
    before = tsf.render_flat_spectral_megakernel.launches
    for engine in ("auto", "fused", "cuda"):
        flat = sp.render_flat_engine(scene, cam, width=16, height=8,
                                     spectral=True, engine=engine, **kw)
        torch.testing.assert_close(flat, want, rtol=0, atol=0)
    assert tsf.render_flat_spectral_megakernel.launches == before
    img = sp.render(scene, cam, 16, 8, samples_per_pixel=1, max_depth=2,
                    seed=4, spectral=True)
    assert img.shape == (8, 16, 3) and img.dtype == np.uint8


def test_render_spectral_mesh_scene_on_cpu():
    scene = _port_mesh_scene(_tetra(0))
    cam = _mesh_camera(16, 8)
    kw = dict(spp=1, max_depth=2, seed=2)
    # under auto a mesh scene on the CPU takes the spectral wavefront
    assert sp.select_engine(scene, "physical", True) == "wavefront"
    img = sp.render(scene, cam, 16, 8, samples_per_pixel=1, max_depth=2,
                    spectral=True)
    assert img.shape == (8, 16, 3) and img.dtype == np.uint8
    before = tsb.render_flat_spectral_bvh_megakernel.launches
    flat = sp.render_flat_engine(scene, cam, width=16, height=8,
                                 spectral=True, engine="cuda_spectral_bvh",
                                 **kw)
    torch.testing.assert_close(
        flat, tsb.render_flat_spectral_bvh_fused(scene, cam, width=16,
                                                 height=8, **kw),
        rtol=0, atol=0)
    assert tsb.render_flat_spectral_bvh_megakernel.launches == before
    with pytest.raises(ValueError, match="RGB only"):
        sp.render(scene, cam, 16, 8, samples_per_pixel=1, max_depth=1,
                  spectral=True, engine="cuda_bvh")
    # the spectral wavefront renders physical transport whatever the
    # semantics, as JAX's trace_spectral does
    torch.testing.assert_close(
        sp.render_flat_engine(scene, cam, width=16, height=8, spp=1,
                              max_depth=1, spectral=True,
                              semantics="reference"),
        sp.render_flat_engine(scene, cam, width=16, height=8, spp=1,
                              max_depth=1, spectral=True,
                              engine="wavefront"), rtol=0, atol=0)


def test_spectral_wrapper_refusals():
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    kw = dict(width=8, height=8, spp=1, max_depth=1)
    verts = np.array([[i, i % 2, -2.0] for i in range(35)], np.float32)
    faces = np.array([[i, i + 1, i + 2] for i in range(33)])
    big = dataclasses.replace(scene,
                              triangles=sp.make_triangles(verts, faces, 0,
                                                           device="cpu"))
    for fn in (tsf.render_flat_spectral_megakernel,
               tsf.render_flat_fused_spectral):
        with pytest.raises(ValueError, match="at most 32"):
            fn(big, cam, **kw)
    with pytest.raises(ValueError, match="attach_packed"):
        tsb.render_flat_spectral_bvh_megakernel(scene, cam, **kw)
    with pytest.raises(TypeError):
        tsb.render_flat_spectral_bvh_megakernel(scene, cam, tile_h=8, **kw)
