"""The port's packed-BVH walk and mesh render against the JAX packet-BVH
kernels, run as the JAX tests run them on the CPU (``interpret=True``), and
against the scalar NumPy oracle; plus the ``cuda_bvh`` engine's CPU path
and the refusals of the BVH wrappers."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.kernels import bvh_megakernel as jbk
from spira_tpu.scene.scene import create_mesh_scene as j_create_mesh_scene
from spira_tpu_torch.accel import pairs as tpairs
from spira_tpu_torch.accel.bvh import build_bvh_for_triangles
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.kernels import megakernel as tmk
from spira_tpu_torch.scene.obj import icosphere

torch.set_num_threads(1)

#: primary hits: same miss set, t within these (the JAX kernel's BW leaf
#: test refines an approximate reciprocal; the port divides exactly)
T_RTOL, T_ATOL = 1e-4, 1e-5
#: whole images: channel means within 0.5%, 99% of pixel-channels within
#: 1e-4 (a rare branch flip moves a whole path)
MEAN_REL, PIX_ATOL, PIX_FRAC = 0.005, 1e-4, 0.99
W, H = 128, 16


@pytest.fixture(scope="module")
def mesh():
    """attach_packed(create_mesh_scene(subdivisions=2)) in both packages,
    the port's from the JAX arrays, and the JAX camera."""
    jscene = j_attach_packed(j_create_mesh_scene(subdivisions=2))
    jcam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          aspect_ratio=W / H)
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (jscene, jcam), (sp.scene_from_numpy(as_np[0], device="cpu"),
                            sp.camera_from_numpy(as_np[1], device="cpu"))


def _random_rays(n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def test_intersect_matches_jax_kernel_and_oracle(mesh):
    """1024 random rays: the plain walk against JAX ``intersect_tile``
    (interpret mode) and against ``traverse_packed_numpy``: the same miss
    set, t to rtol 1e-4 / atol 1e-5, mat id equal."""
    (jscene, _), (scene, _) = mesh
    origins, dirs = _random_rays(1024, seed=3)
    aim = np.array([0.0, 0.1, 0.0], np.float32) - origins[:512]
    dirs[:512] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    t, n, mid = tbk.intersect_tile(scene.packed, torch.from_numpy(origins),
                                   torch.from_numpy(dirs))
    t, n, mid = t.numpy(), n.numpy(), mid.numpy()
    jt, jn, jmid = (np.asarray(x) for x in jbk.intersect_tile(
        jscene.packed, origins, dirs, interpret=True))
    hit = jt < 1e19
    assert 300 < hit.sum() < 1024
    np.testing.assert_array_equal(t < 1e19, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_allclose(n[hit], jn[hit], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(mid, jmid)
    assert (t[~hit] == tmk.INF).all() and (mid[~hit] == -1).all()
    assert (n[~hit] == 0.0).all()
    for k in range(0, 1024, 8):
        ot, on, om = tpairs.traverse_packed_numpy(scene.packed, origins[k],
                                                  dirs[k])
        assert np.isfinite(ot) == hit[k], k
        if hit[k]:
            np.testing.assert_allclose(t[k], ot, rtol=T_RTOL, atol=T_ATOL)
            np.testing.assert_allclose(n[k], on, rtol=T_RTOL, atol=T_ATOL)
            assert mid[k] == om


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_intersect_forms_slots_and_active(form):
    """Both leaf forms find the same hits; the winner slot maps through
    prim_map to a triangle of the winning material; inactive rays miss."""
    scene = sp.create_mesh_scene(subdivisions=1, device="cpu")
    packed = tpairs.pack_bvh(scene.bvh, scene.triangles, form=form)
    origins, dirs = _random_rays(512, seed=5, spread=1.5)
    aim = np.array([0.0, 0.1, 0.0], np.float32) - origins[::2]
    dirs[::2] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    active = torch.arange(512) % 3 != 0
    t, n, mid, slot = tbk.intersect_tile(packed, o, d, active=active,
                                         with_slot=True)
    ref_t, _, ref_mid = tbk.intersect_packed_plain(
        tpairs.pack_bvh(scene.bvh, scene.triangles, form="mt"), o, d)
    hit = t < 1e19
    assert hit.sum() > 100
    assert not hit[~active].any()
    assert (slot[~hit] == -1).all() and (mid[~hit] == -1).all()
    torch.testing.assert_close(t[active], ref_t[active], rtol=T_RTOL,
                               atol=T_ATOL)
    assert (mid[active] == ref_mid[active]).all()
    tri = packed.prim_map[slot[hit].long()].long()
    assert (tri >= 0).all()
    assert (scene.triangles.material[tri] == mid[hit]).all()
    torch.testing.assert_close(scene.triangles.normal[tri], n[hit])


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_plain_walk_over_compacted_octant_list_scatters_back(form):
    """What compacting kernel #3's live rays and grouping them by
    direction octant rely on: a ray's hit does not depend on which rays
    are walked beside it or in what order.  The plain walk over the live rays alone, grouped by direction
    octant and shuffled within each group, scattered back to their
    indices over a miss, equals the call over all rays with ``active``,
    to the bit (t, normal, material id, slot)."""
    scene = sp.create_mesh_scene(subdivisions=1, device="cpu")
    packed = tpairs.pack_bvh(scene.bvh, scene.triangles, form=form)
    origins, dirs = _random_rays(512, seed=8, spread=1.5)
    aim = np.array([0.0, 0.1, 0.0], np.float32) - origins[::2]
    dirs[::2] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    rng = np.random.default_rng(9)
    active = torch.from_numpy(rng.uniform(size=512) < 0.4)
    want = tbk.intersect_packed_plain(packed, o, d, active, True)
    live = np.flatnonzero(active.numpy())
    octant = ((dirs[live] < 0) * np.array([1, 2, 4])).sum(1)
    assert len(np.unique(octant)) == 8
    order = live[np.lexsort((rng.permutation(live.size), octant))]
    idx = torch.from_numpy(order)
    part = tbk.intersect_packed_plain(packed, o[idx], d[idx], None, True)
    got = (torch.full((512,), 1e20), torch.zeros((512, 3)),
           torch.full((512,), -1, dtype=torch.int32),
           torch.full((512,), -1, dtype=torch.int32))
    for full, some in zip(got, part):
        full[idx] = some
    assert int((want[0] < 1e19).sum()) > 50
    for name, a, b in zip(("t", "normal", "mat id", "slot"), got, want):
        assert torch.equal(a, b), name


def test_render_matches_jax_kernel(mesh):
    """The plain render against JAX ``render_flat_bvh_megakernel``
    (interpret mode), same scene values and seed, at 128x16, spp 1,
    depth 2."""
    (jscene, jcam), (scene, cam) = mesh
    kw = dict(width=W, height=H, spp=1, max_depth=2, seed=0)
    want = np.asarray(jbk.render_flat_bvh_megakernel(jscene, jcam,
                                                     interpret=True, **kw))
    got = tbk.render_flat_bvh_fused(scene, cam, **kw).numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    assert got.std() > 1e-3
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= PIX_ATOL).mean() >= PIX_FRAC


def test_render_engine_cuda_bvh_on_cpu(mesh):
    """engine='cuda_bvh' on a CPU scene runs the plain version; the
    wrapper launches nothing; 'auto' sends a mesh scene on the CPU to the
    wavefront estimator, as JAX's select_engine does off the TPU."""
    _, (scene, cam) = mesh
    kw = dict(spp=1, max_depth=2, seed=3)
    want = tbk.render_flat_bvh_fused(scene, cam, width=32, height=8, **kw)
    before = tbk.render_flat_bvh_megakernel.launches
    flat = sp.render_flat_engine(scene, cam, width=32, height=8,
                                 engine="cuda_bvh", **kw)
    torch.testing.assert_close(flat, want, rtol=0, atol=0)
    assert tbk.render_flat_bvh_megakernel.launches == before
    img = sp.render(scene, cam, 32, 8, samples_per_pixel=1, max_depth=2,
                    seed=3, engine="cuda_bvh")
    assert img.shape == (8, 32, 3) and img.dtype == np.uint8
    assert sp.select_engine(scene, "physical", False) == "wavefront"
    before = tbk.render_flat_bvh_megakernel.launches
    img = sp.render(scene, cam, 32, 8, samples_per_pixel=1, max_depth=1)
    assert img.shape == (8, 32, 3) and img.dtype == np.uint8
    assert tbk.render_flat_bvh_megakernel.launches == before
    bvh_only = dataclasses.replace(scene, packed=None)
    assert sp.select_engine(bvh_only, "physical", False) == "wavefront"
    with pytest.raises(ValueError, match="RGB only"):
        sp.render(scene, cam, 32, 8, samples_per_pixel=1, max_depth=1,
                  engine="cuda_bvh", spectral=True)
    with pytest.raises(ValueError, match="physical semantics only"):
        sp.render(scene, cam, 32, 8, samples_per_pixel=1, max_depth=1,
                  engine="cuda_bvh", semantics="reference")


def test_mesh_free_packed_scene_renders_as_sphere_kernel():
    """Triangles that no ray reaches leave the sphere tracer's image
    bit for bit: the BVH path shares its PCG stream and shading."""
    # below the ground sphere: every ray toward it meets the ground first
    far = icosphere(center=(0.0, -300.0, 0.0), radius=0.1, subdivisions=1)
    base = sp.create_scene(device="cpu")
    scene = sp.attach_packed(dataclasses.replace(
        base, triangles=far,
        bvh=build_bvh_for_triangles(far)))
    cam = sp.default_camera(4.0, device="cpu")
    kw = dict(width=32, height=8, spp=2, max_depth=3, seed=9)
    torch.testing.assert_close(
        tbk.render_flat_bvh_fused(scene, cam, **kw),
        tmk.render_flat_fused(base, cam, **kw), rtol=0, atol=0)


def test_wrapper_refusals(mesh):
    _, (scene, cam) = mesh
    kw = dict(width=8, height=8, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="attach_superleaf"):
        tbk.render_flat_bvh_megakernel(scene, cam, mxu_leaf=True, **kw)
    with pytest.raises(ValueError, match="attach_packed"):
        tbk.render_flat_bvh_megakernel(
            dataclasses.replace(scene, packed=None), cam, **kw)
    deep = dataclasses.replace(
        scene, packed=dataclasses.replace(
            scene.packed, depth=tpairs.TRAVERSAL_STACK + 1))
    with pytest.raises(ValueError, match="traversal stack"):
        tbk.render_flat_bvh_megakernel(deep, cam, **kw)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="traversal stack"):
        tbk.intersect_tile(deep.packed, o, o)
    with pytest.raises(TypeError):
        tbk.render_flat_bvh_megakernel(scene, cam, tile_h=32, **kw)


def test_pack_materials_matches_jax(mesh):
    (jscene, _), (scene, _) = mesh
    np.testing.assert_array_equal(
        tbk.pack_materials(scene.materials).numpy(),
        np.asarray(jbk.pack_materials_jnp(jscene.materials)))
