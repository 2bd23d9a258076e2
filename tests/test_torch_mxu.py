"""The port's superleaf engines against the JAX package on the CPU: the
wide, MXU and superleaf tables value-exact, the three NumPy oracles equal,
the plain streaming query, superleaf walk and both plain superleaf
renders against JAX's Pallas kernels run as the JAX tests run them
(``interpret=True``), the engines ``cuda_mxu`` and ``cuda_bvh_mxu`` on
CPU scenes, and their refusals."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel import mxu as jmxu
from spira_tpu.accel import wide as jwide
from spira_tpu.accel.bvh import build_bvh_for_triangles as j_build_bvh
from spira_tpu.accel.bvh import build_two_level as j_build_two_level
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.kernels import bvh_megakernel as jbk
from spira_tpu.kernels import mxu_megakernel as jmk
from spira_tpu.scene import obj as jobj
from spira_tpu.scene.scene import create_mesh_scene as j_create_mesh_scene
from spira_tpu_torch import experiments
from spira_tpu_torch.accel import mxu as tmxu
from spira_tpu_torch.accel import pairs as tpairs
from spira_tpu_torch.accel import wide as twide
from spira_tpu_torch.accel.bvh import build_bvh_for_triangles as t_build_bvh
from spira_tpu_torch.accel.bvh import build_two_level as t_build_two_level
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.kernels import mxu_megakernel as tmk
from spira_tpu_torch.scene import obj as tobj

torch.set_num_threads(1)

#: nearest hits against JAX's streaming kernel: XLA sums the Plücker
#: contraction in its own order, so t to rtol 1e-5, normals (payload
#: values, picked by the same lane) to atol 1e-5, material ids equal
T_RTOL, N_ATOL = 1e-5, 1e-5
#: hits of the superleaf walk against the row-leaf walk: another leaf test
#: (Plücker against Baldwin–Weber), the same triangles: t to rtol 1e-4 /
#: atol 1e-5, the miss sets and material ids equal
WALK_RTOL, WALK_ATOL = 1e-4, 1e-5
#: whole images against JAX (and against the row-leaf render): every
#: pixel-channel within 1e-4 (same PCG stream, the intersectors differ in
#: their last bits)
PIX_ATOL = 1e-4
W, H = 128, 8


def _two_spheres(ico, build_two_level):
    """The two-icosphere scene of tests/test_mxu_stream.py:35-40."""
    m0 = ico(center=(-0.6, 0.1, 0.0), radius=0.55, subdivisions=2,
             material=0)
    m1 = ico(center=(0.8, -0.2, 0.3), radius=0.45, subdivisions=1,
             material=1)
    return build_two_level([m0, m1])


def _root_cut(ico, build):
    """80 triangles under one cut: the root is the single superleaf
    (tests/test_mxu.py:_mesh(1))."""
    tris = ico(material=3, subdivisions=1)
    return build(tris, leaf_size=4, use_native=False), tris


@pytest.fixture(scope="module")
def trees():
    """(JAX bvh, tris), (port bvh, tris) for both scenes."""
    return {
        "two_spheres": (_two_spheres(jobj.icosphere, j_build_two_level),
                        _two_spheres(tobj.icosphere, t_build_two_level)),
        "root_cut": (_root_cut(jobj.icosphere, j_build_bvh),
                     _root_cut(tobj.icosphere, t_build_bvh)),
    }


def _assert_tables_equal(port, ref):
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        else:
            assert type(got) is type(want) and got == want, f.name


PACKINGS = {
    "wide": (jwide.pack_bvh16, twide.pack_bvh16, {}),
    "mxu_128": (jmxu.pack_bvh_mxu, tmxu.pack_bvh_mxu, {}),
    "mxu_32": (jmxu.pack_bvh_mxu, tmxu.pack_bvh_mxu, dict(superleaf=32)),
    "superleaf_128": (jmxu.pack_bvh_superleaf, tmxu.pack_bvh_superleaf, {}),
    "superleaf_32": (jmxu.pack_bvh_superleaf, tmxu.pack_bvh_superleaf,
                     dict(superleaf=32)),
}


@pytest.mark.parametrize("scene", ["two_spheres", "root_cut"])
@pytest.mark.parametrize("packing", sorted(PACKINGS))
def test_tables_equal_jax(trees, scene, packing):
    """Every table and static field value for value, bin packing
    included: a wrong block index would hide behind co-resident blocks on
    most rays."""
    (jbvh, jtris), (tbvh, ttris) = trees[scene]
    jpack, tpack, kw = PACKINGS[packing]
    port = tpack(tbvh, ttris, **kw)
    _assert_tables_equal(port, jpack(jbvh, jtris, **kw))
    if scene == "root_cut" and packing != "wide":
        assert (port.n_leaves if packing.startswith("mxu")
                else port.n_blocks) == 1


def _rays(n, seed, spread=2.0, aimed=0):
    """Random rays; the first ``aimed`` of them point at the origin."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:aimed] = -origins[:aimed]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


ORACLES = {
    "wide": (jwide.pack_bvh16, jwide.traverse_wide_numpy, twide.pack_bvh16,
             twide.traverse_wide_numpy),
    "mxu": (jmxu.pack_bvh_mxu, jmxu.traverse_mxu_numpy, tmxu.pack_bvh_mxu,
            tmxu.traverse_mxu_numpy),
    "superleaf": (jmxu.pack_bvh_superleaf, jmxu.traverse_superleaf_numpy,
                  tmxu.pack_bvh_superleaf, tmxu.traverse_superleaf_numpy),
}


@pytest.mark.parametrize("kind", sorted(ORACLES))
def test_oracles_equal_jax(trees, kind):
    (jbvh, jtris), (tbvh, ttris) = trees["two_spheres"]
    jpack, jwalk, tpack, twalk = ORACLES[kind]
    jtab, ttab = jpack(jbvh, jtris), tpack(tbvh, ttris)
    origins, dirs = _rays(96, seed=4, aimed=48)
    hits = 0
    for o, d in zip(origins, dirs):
        (jt, jn, jm), (t, n, m) = jwalk(jtab, o, d), twalk(ttab, o, d)
        assert t == jt and m == jm
        np.testing.assert_array_equal(n, jn)
        hits += np.isfinite(t)
    assert 10 < hits < 96


def test_intersect_mxu_plain_matches_jax(trees):
    """The plain streaming query against JAX ``intersect_tile_mxu``
    (interpret mode) on 1,024 rays, and against the oracle; the wrapper on
    CPU tensors is the plain version and launches nothing."""
    (jbvh, jtris), (tbvh, ttris) = trees["two_spheres"]
    jtab, ttab = jmxu.pack_bvh_mxu(jbvh, jtris), tmxu.pack_bvh_mxu(tbvh, ttris)
    origins, dirs = _rays(1024, seed=3, aimed=512)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    t, n, mid = (x.numpy() for x in tmk.intersect_mxu_plain(ttab, o, d))
    jt, jn, jmid = (np.asarray(x) for x in jmk.intersect_tile_mxu(
        jtab, origins, dirs, interpret=True))
    hit = jt < 1e19
    assert 100 < hit.sum() < 1024
    np.testing.assert_array_equal(t < 1e19, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=0)
    np.testing.assert_array_equal(mid, jmid)
    np.testing.assert_allclose(n, jn, rtol=0, atol=N_ATOL)
    assert (t[~hit] == 1e20).all() and (mid[~hit] == -1).all()
    for k in range(0, 1024, 16):
        ot, on, om = tmxu.traverse_mxu_numpy(ttab, origins[k], dirs[k])
        assert np.isfinite(ot) == hit[k]
        if hit[k]:
            np.testing.assert_allclose(t[k], ot, rtol=T_RTOL)
            assert mid[k] == om
    before = tmk.intersect_tile_mxu.launches
    for a, b in zip(tmk.intersect_tile_mxu(ttab, o, d),
                    tmk.intersect_mxu_plain(ttab, o, d)):
        assert torch.equal(a, b)
    assert tmk.intersect_tile_mxu.launches == before


def test_superleaf_walk_matches_oracle_and_row_walk(trees):
    """The plain superleaf walk (``intersect_packed_plain`` over a
    SuperleafBVH) against ``traverse_superleaf_numpy`` and against the row
    leaves' walk of the same tree, and against the block stream."""
    _, (tbvh, ttris) = trees["two_spheres"]
    tree = tmxu.pack_bvh_superleaf(tbvh, ttris)
    rows = tpairs.pack_bvh(tbvh, ttris)
    origins, dirs = _rays(1024, seed=7, aimed=512)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    t, n, mid = (x.numpy() for x in tbk.intersect_packed_plain(tree, o, d))
    rt, rn, rmid = (x.numpy() for x in tbk.intersect_packed_plain(rows, o, d))
    hit = t < 1e19
    assert 200 < hit.sum() < 1024
    np.testing.assert_array_equal(rt < 1e19, hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=WALK_RTOL,
                               atol=WALK_ATOL)
    np.testing.assert_array_equal(mid, rmid)
    np.testing.assert_allclose(n, rn, rtol=0, atol=N_ATOL)
    # the block stream tests the same lanes with the same arithmetic
    st_t, st_n, st_mid = (x.numpy() for x in tmk.intersect_mxu_plain(
        tree, o, d))
    np.testing.assert_array_equal(st_t, t)
    np.testing.assert_array_equal(st_mid, mid)
    for k in range(0, 1024, 8):
        ot, on, om = tmxu.traverse_superleaf_numpy(tree, origins[k], dirs[k])
        assert np.isfinite(ot) == hit[k]
        if hit[k]:
            np.testing.assert_allclose(t[k], ot, rtol=T_RTOL)
            np.testing.assert_allclose(n[k], on, atol=N_ATOL)
            assert mid[k] == om


@pytest.fixture(scope="module")
def mesh():
    """create_mesh_scene(subdivisions=1) in both packages with each
    superleaf packing on ``wide``; the port's from the JAX arrays."""
    base = j_attach_packed(j_create_mesh_scene(subdivisions=1))
    jcam = st.make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          aspect_ratio=W / H)
    jscenes = dict(mxu=jmxu.attach_mxu(base),
                   superleaf=jmxu.attach_superleaf(base))
    scenes = {k: sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                     device="cpu")
              for k, v in jscenes.items()}
    cam = sp.camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam),
                               device="cpu")
    return jscenes, jcam, scenes, cam


KW = dict(width=W, height=H, spp=1, max_depth=2, seed=0)


def test_render_mxu_matches_jax(mesh):
    """``render_flat_mxu_fused`` against JAX
    ``render_flat_mxu_megakernel`` (interpret mode), 128x8 spp 1 d 2."""
    jscenes, jcam, scenes, cam = mesh
    want = np.asarray(jmk.render_flat_mxu_megakernel(
        jscenes["mxu"], jcam, interpret=True, **KW))
    got = tmk.render_flat_mxu_fused(scenes["mxu"], cam, **KW).numpy()
    assert got.shape == (W * H, 3) and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_ATOL)


def test_render_bvh_mxu_matches_jax(mesh):
    """``render_flat_bvh_fused(mxu_leaf=True)`` against JAX
    ``render_flat_bvh_megakernel(mxu_leaf=True, tile_h=8)``."""
    jscenes, jcam, scenes, cam = mesh
    want = np.asarray(jbk.render_flat_bvh_megakernel(
        jscenes["superleaf"], jcam, interpret=True, mxu_leaf=True, tile_h=8,
        **KW))
    got = tbk.render_flat_bvh_fused(scenes["superleaf"], cam, mxu_leaf=True,
                                    **KW).numpy()
    assert got.shape == (W * H, 3) and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_ATOL)


def test_plain_superleaf_renders_match_row_render(mesh):
    """Both plain superleaf renders against the plain row-leaf render of
    the same scene and seed (same PCG stream, other intersectors), and the
    wrappers on CPU scenes are the plain versions."""
    _, _, scenes, cam = mesh
    kw = dict(KW, spp=2, max_depth=3, seed=4)
    rows = tbk.render_flat_bvh_fused(scenes["mxu"], cam, **kw)
    stream = tmk.render_flat_mxu_fused(scenes["mxu"], cam, **kw)
    walk = tbk.render_flat_bvh_fused(scenes["superleaf"], cam,
                                     mxu_leaf=True, **kw)
    torch.testing.assert_close(stream, rows, rtol=0, atol=PIX_ATOL)
    torch.testing.assert_close(walk, stream, rtol=0, atol=0)
    before = (tmk.render_flat_mxu_megakernel.launches,
              tbk.render_flat_bvh_mxu_megakernel.launches)
    torch.testing.assert_close(
        tmk.render_flat_mxu_megakernel(scenes["mxu"], cam, **kw), stream,
        rtol=0, atol=0)
    torch.testing.assert_close(
        tbk.render_flat_bvh_megakernel(scenes["superleaf"], cam,
                                       mxu_leaf=True, **kw), walk,
        rtol=0, atol=0)
    assert (tmk.render_flat_mxu_megakernel.launches,
            tbk.render_flat_bvh_mxu_megakernel.launches) == before


def _records_numpy(coeff_uv, coeff_t):
    """The lane records and offsets of the tables, by a NumPy loop over
    blocks and lanes: the lane's coeff_uv rows 0-5 of its det, u_num and
    v_num columns, coeff_t rows 0-2 and 6, two zeros; a block's lanes up
    to its last with a non-zero coefficient."""
    uv = np.asarray(coeff_uv).reshape(-1, 8, 384)
    tc = np.asarray(coeff_t).reshape(-1, 8, 128)
    records, offsets = [], [0]
    for b in range(uv.shape[0]):
        nonzero = [j for j in range(128)
                   if uv[b, :, j::128].any() or tc[b, :, j].any()]
        count = nonzero[-1] + 1 if nonzero else 0
        for j in range(count):
            records.append(np.concatenate([
                uv[b, 0:6, j], uv[b, 0:6, 128 + j], uv[b, 0:6, 256 + j],
                tc[b, [0, 1, 2, 6], j], np.zeros(2, np.float32)]))
        offsets.append(offsets[-1] + count)
    return (np.asarray(records, np.float32).reshape(-1, 24),
            np.asarray(offsets, np.int32))


def _assert_lanes_match(tables, ref):
    """``tables.lanes`` against :func:`_records_numpy` of ``ref``'s
    tables, value for value: every record inside its block's range of
    real lanes, and each block's lanes past that range all zero."""
    lanes = tables.lanes
    records, offsets = _records_numpy(ref.coeff_uv, ref.coeff_t)
    assert lanes.records.dtype == torch.float32
    assert lanes.offsets.dtype == torch.int32
    np.testing.assert_array_equal(lanes.records.numpy(), records)
    np.testing.assert_array_equal(lanes.offsets.numpy(), offsets)
    counts = np.diff(offsets)
    assert (counts >= 0).all() and (counts <= tmxu.SUPERLEAF).all()
    assert lanes.n_lanes == offsets[-1] == records.shape[0]
    assert lanes.max_lanes == counts.max()
    uv = np.asarray(ref.coeff_uv).reshape(-1, 8, 3, 128)
    tc = np.asarray(ref.coeff_t).reshape(-1, 8, 128)
    for b, count in enumerate(counts):  # no record straddles a block
        assert not uv[b, :, :, count:].any() and not tc[b, :, count:].any()
        if count:
            assert uv[b, :, :, count - 1].any() or tc[b, :, count - 1].any()


@pytest.mark.parametrize("packing", ["mxu_128", "mxu_32", "superleaf_128",
                                     "superleaf_32"])
def test_lane_records_equal_tables(trees, packing):
    """The lane records (``lanes``) of a port-packed tree equal the JAX
    tables' entries, value for value, with each block's real-lane count;
    the lanes are derived once per tree object."""
    (jbvh, jtris), (tbvh, ttris) = trees["two_spheres"]
    jpack, tpack, kw = PACKINGS[packing]
    port = tpack(tbvh, ttris, **kw)
    _assert_lanes_match(port, jpack(jbvh, jtris, **kw))
    assert port.lanes is port.lanes
    assert (np.diff(port.lanes.offsets.numpy()) < tmxu.SUPERLEAF).any()


@pytest.mark.parametrize("kind", ["mxu", "superleaf"])
def test_converted_scene_has_lane_records(kind):
    """A scene converted from JAX's arrays (``scene_from_numpy``) derives
    its lane records from the converted tables: equal to JAX's entries."""
    attach = dict(mxu=jmxu.attach_mxu, superleaf=jmxu.attach_superleaf)[kind]
    ref = attach(j_create_mesh_scene(subdivisions=1))
    conv = sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                               device="cpu")
    _assert_lanes_match(conv.wide, ref.wide)


@pytest.mark.parametrize("kind", ["wide", "mxu", "superleaf"])
def test_converter_carries_wide(kind):
    attach = dict(wide=jwide.attach_wide, mxu=jmxu.attach_mxu,
                  superleaf=jmxu.attach_superleaf)[kind]
    ref = attach(j_create_mesh_scene(subdivisions=1))
    conv = sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                               device="cpu")
    want_type = dict(wide=twide.WideBVH, mxu=tmxu.MXUBVH,
                     superleaf=tmxu.SuperleafBVH)[kind]
    assert type(conv.wide) is want_type
    _assert_tables_equal(conv.wide, ref.wide)
    own = dict(wide=sp.attach_wide, mxu=sp.attach_mxu,
               superleaf=sp.attach_superleaf)[kind](
        sp.create_mesh_scene(subdivisions=1, device="cpu"))
    _assert_tables_equal(own.wide, ref.wide)


def test_engines_on_cpu(mesh):
    """``cuda_mxu`` and ``cuda_bvh_mxu`` on CPU scenes run the plain
    versions, attach their packing when ``wide`` holds another, and
    ``auto`` never picks them; ``experiments`` routes to them."""
    _, _, scenes, cam = mesh
    kw = dict(width=32, height=8, spp=1, max_depth=2, seed=3)
    stream = tmk.render_flat_mxu_fused(scenes["mxu"], cam, **kw)
    walk = tbk.render_flat_bvh_fused(scenes["superleaf"], cam,
                                     mxu_leaf=True, **kw)
    for scene in scenes.values():  # each engine packs what it needs
        torch.testing.assert_close(sp.render_flat_engine(
            scene, cam, engine="cuda_mxu", **kw), stream, rtol=0, atol=0)
        torch.testing.assert_close(sp.render_flat_engine(
            scene, cam, engine="cuda_bvh_mxu", **kw), walk, rtol=0, atol=0)
    torch.testing.assert_close(
        experiments.render_flat_mxu(scenes["mxu"], cam, **kw), stream,
        rtol=0, atol=0)
    torch.testing.assert_close(
        experiments.render_flat_bvh_mxu(scenes["superleaf"], cam, **kw),
        walk, rtol=0, atol=0)
    img = sp.render(scenes["mxu"], cam, 32, 8, samples_per_pixel=1,
                    max_depth=2, engine="cuda_mxu")
    assert img.shape == (8, 32, 3) and img.dtype == np.uint8
    # never under auto: a mesh scene on the CPU takes the wavefront
    assert sp.select_engine(scenes["mxu"], "physical", False) == "wavefront"


def test_engine_and_wrapper_refusals(mesh):
    _, _, scenes, cam = mesh
    kw = dict(width=8, height=8, spp=1, max_depth=1)
    for engine in ("cuda_mxu", "cuda_bvh_mxu"):
        with pytest.raises(ValueError, match="RGB only"):
            sp.render(scenes["mxu"], cam, 8, 8, samples_per_pixel=1,
                      max_depth=1, engine=engine, spectral=True)
        with pytest.raises(ValueError, match="physical semantics only"):
            sp.render(scenes["mxu"], cam, 8, 8, samples_per_pixel=1,
                      max_depth=1, engine=engine, semantics="reference")
        bare = dataclasses.replace(scenes["mxu"], bvh=None, wide=None)
        with pytest.raises(ValueError, match="built BVH"):
            sp.render(bare, cam, 8, 8, samples_per_pixel=1, max_depth=1,
                      engine=engine)
    with pytest.raises(ValueError, match="attach_mxu"):
        tmk.render_flat_mxu_megakernel(
            dataclasses.replace(scenes["mxu"], wide=None), cam, **kw)
    with pytest.raises(ValueError, match="attach_superleaf"):
        tbk.render_flat_bvh_megakernel(scenes["mxu"], cam, mxu_leaf=True,
                                       **kw)
    with pytest.raises(TypeError):
        tbk.render_flat_bvh_megakernel(scenes["superleaf"], cam,
                                       mxu_leaf=True,
                                       mxu_precision="highest", **kw)
    deep = dataclasses.replace(scenes["superleaf"], wide=dataclasses.replace(
        scenes["superleaf"].wide, depth=tpairs.TRAVERSAL_STACK + 1))
    with pytest.raises(ValueError, match="traversal stack"):
        tbk.render_flat_bvh_megakernel(deep, cam, mxu_leaf=True, **kw)
    with pytest.raises(ValueError, match="superleaf must be"):
        tmxu.pack_bvh_mxu(scenes["mxu"].bvh, scenes["mxu"].triangles,
                          superleaf=129)
