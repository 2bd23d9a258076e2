"""The port's mesh host side against the JAX package: OBJ parsing and the
procedural meshes, the BVH builders, the packed tables and the converter,
all value-exact; and the packer's refusals of trees the kernels cannot
walk."""

import os
import re

import jax
import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu.accel import bvh as jbvh
from spira_tpu.accel import pairs as jpairs
from spira_tpu.scene import bunny as jbunny
from spira_tpu.scene import obj as jobj
from spira_tpu.scene.scene import create_mesh_scene as j_create_mesh_scene
from spira_tpu_torch.accel import bvh as tbvh
from spira_tpu_torch.accel import pairs as tpairs
from spira_tpu_torch.scene import bunny as tbunny
from spira_tpu_torch.scene import obj as tobj
from spira_tpu_torch.scene.geometry import triangle_bounds

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREFOIL = os.path.join(ROOT, "assets", "trefoil.obj")
TRI_FIELDS = ("v0", "e1", "e2", "normal", "material")
BVH_FIELDS = ("node_min", "node_max", "left", "right", "is_leaf", "prim_idx",
              "parent", "sibling", "is_left")
PACKED_FIELDS = ("pairs", "tri_rows", "prim_map")
PACKED_META = ("root", "n_rows", "n_pairs", "max_leaf", "depth", "form",
               "fanout")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_equal(port, ref, fields):
    for f in fields:
        got, want = _np(getattr(port, f)), _np(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _assert_meta(port, ref, fields):
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_obj_trefoil(use_native):
    text = open(TREFOIL).read()
    v, f = tobj.parse_obj(text, use_native=use_native)
    jv, jf = jobj.parse_obj(text, use_native=use_native)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == np.float32 and f.dtype == np.int64


def test_load_obj_mesh_and_transform():
    kw = dict(material=2, center=True, normalize=True, scale=0.6,
              rotate_xyz=(10.0, 20.0, 30.0), translate=(0.0, 0.1, 0.0))
    _assert_equal(tobj.load_obj_mesh(TREFOIL, **kw),
                  jobj.load_obj_mesh(TREFOIL, **kw), TRI_FIELDS)
    with pytest.raises(ValueError, match="no triangles"):
        tobj.parse_obj("v 0 0 0\n", use_native=False)


@pytest.mark.parametrize("subdivisions", [0, 2])
def test_icosphere_and_cube(subdivisions):
    kw = dict(center=(0.3, -0.2, 1.0), radius=0.7, subdivisions=subdivisions,
              material=1)
    _assert_equal(tobj.icosphere(**kw), jobj.icosphere(**kw), TRI_FIELDS)
    _assert_equal(tobj.cube((1.0, 2.0, 3.0), 0.5, 3),
                  jobj.cube((1.0, 2.0, 3.0), 0.5, 3), TRI_FIELDS)


def test_procedural_bunny_parts_and_camera():
    port = tbunny.procedural_bunny(material=0, scale=0.62)
    ref = jbunny.procedural_bunny(material=0, scale=0.62)
    assert len(port) == len(ref) == 9
    assert sum(p.count for p in port) == 72960
    for p, r in zip(port, ref):
        _assert_equal(p, r, TRI_FIELDS)
    cam = tbunny.bunny_camera(16 / 9, device="cpu")
    jcam = jbunny.bunny_camera(16 / 9)
    _assert_equal(cam, jcam, ("origin", "u", "v", "lens_radius"))


@pytest.mark.parametrize("use_native", [True, False])
def test_build_bvh_for_triangles(use_native):
    mesh = tobj.icosphere(radius=1.0, subdivisions=2)
    jmesh = jobj.icosphere(radius=1.0, subdivisions=2)
    got = tbvh.build_bvh_for_triangles(mesh, use_native=use_native)
    want = jbvh.build_bvh_for_triangles(jmesh, use_native=use_native)
    _assert_equal(got, want, BVH_FIELDS)
    assert got.max_leaf == want.max_leaf
    lo, hi = triangle_bounds(mesh)
    tbvh.validate_bvh(got, lo, hi)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_two_level_mesh_scene(use_native):
    """build_two_level of create_mesh_scene(subdivisions=2)'s meshes, and
    the scene itself, equal the JAX package's arrays."""
    parts = [tobj.icosphere((0.0, 0.1, 0.0), 0.6, 2, 0),
             tobj.icosphere((1.3, 0.0, -0.6), 0.45, 2, 3)]
    jparts = [jobj.icosphere((0.0, 0.1, 0.0), 0.6, 2, 0),
              jobj.icosphere((1.3, 0.0, -0.6), 0.45, 2, 3)]
    bvh, tris = tbvh.build_two_level(parts, 16, use_native=use_native)
    jb, jt = jbvh.build_two_level(jparts, 16, use_native=use_native)
    _assert_equal(bvh, jb, BVH_FIELDS)
    _assert_equal(tris, jt, TRI_FIELDS)
    assert bvh.max_leaf == jb.max_leaf
    scene = sp.create_mesh_scene(subdivisions=2, device="cpu")
    ref = j_create_mesh_scene(subdivisions=2)
    _assert_equal(scene.bvh, ref.bvh, BVH_FIELDS)
    _assert_equal(scene.triangles, ref.triangles, TRI_FIELDS)
    _assert_equal(scene.spheres, ref.spheres, ("centers", "radii",
                                               "material"))


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_pack_bvh_value_exact(form):
    scene = sp.create_mesh_scene(subdivisions=2, device="cpu")
    ref = j_create_mesh_scene(subdivisions=2)
    got = tpairs.pack_bvh(scene.bvh, scene.triangles, form=form)
    want = jpairs.pack_bvh(ref.bvh, ref.triangles, form=form)
    _assert_equal(got, want, PACKED_FIELDS)
    _assert_meta(got, want, PACKED_META)
    # the mesh scene's leaves span two rows
    assert got.max_leaf > tpairs.TRIS_PER_ROW


def test_attach_packed_and_converter_value_exact():
    ref = jpairs.attach_packed(j_create_mesh_scene(subdivisions=2))
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=2,
                                                  device="cpu"))
    conv = sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                               device="cpu")
    for port in (scene, conv):
        _assert_equal(port.bvh, ref.bvh, BVH_FIELDS)
        _assert_meta(port.bvh, ref.bvh, ("max_leaf", "n_sph"))
        _assert_equal(port.packed, ref.packed, PACKED_FIELDS)
        _assert_meta(port.packed, ref.packed, PACKED_META)
    with pytest.raises(ValueError, match="built BVH"):
        sp.attach_packed(sp.create_scene(device="cpu"))


def test_traverse_oracle_matches_jax():
    ref = jpairs.attach_packed(j_create_mesh_scene(subdivisions=1))
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    rng = np.random.default_rng(4)
    origins = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    hits = 0
    for o, d in zip(origins, dirs):
        t, n, m = tpairs.traverse_packed_numpy(scene.packed, o, d)
        jt, jn, jm = jpairs.traverse_packed_numpy(ref.packed, o, d)
        assert (t, m) == (jt, jm)
        np.testing.assert_array_equal(n, jn)
        hits += np.isfinite(t)
    assert hits > 0


def _flat(left, right, is_leaf, prim_idx):
    m = len(left)
    box = torch.zeros((m, 3))
    return tbvh.FlatBVH(
        node_min=box, node_max=box + 1.0,
        left=torch.tensor(left, dtype=torch.int32),
        right=torch.tensor(right, dtype=torch.int32),
        is_leaf=torch.tensor(is_leaf, dtype=torch.int32),
        prim_idx=torch.tensor(prim_idx, dtype=torch.int32),
    )


@pytest.mark.parametrize(
    "left,right,match",
    [
        # the row-SAH sweep's best_pos = -1: a leaf of count -1
        ([1, 0, 4], [2, 4, -1], "count -1"),
        # an empty leaf would pack as an internal child
        ([1, 0, 4], [2, 4, 0], "count 0"),
        # a range past prim_idx
        ([1, 0, 3], [2, 3, 2], r"\[3, 5\) of 4"),
        ([1, -1, 3], [2, 3, 1], r"\[-1, 2\)"),
    ],
)
def test_pack_bvh_refuses_bad_leaves(left, right, match):
    """Leaves the C++ builder can emit when its exact sweep finds no finite
    cost, built by hand: the packer raises instead of dropping triangles."""
    tris = tobj.cube()  # 12 triangles; prim_idx holds 4 of them
    bvh = _flat(left, right, [0, 1, 1], [0, 1, 2, 3])
    with pytest.raises(ValueError, match=match):
        tpairs.pack_bvh(bvh, tris)


def _chain(depth):
    """A tree whose pair-record chain is ``depth`` long: internal node k
    has a leaf child and internal child k+1; the last has two leaves."""
    left, right, is_leaf = [], [], []
    n_int = depth
    for k in range(n_int):
        nxt = k + 1 if k + 1 < n_int else n_int + depth  # last: two leaves
        left += [n_int + k]
        right += [nxt]
        is_leaf += [0]
    left += list(range(depth + 1))  # leaves: one primitive each
    right += [1] * (depth + 1)
    is_leaf += [1] * (depth + 1)
    return _flat(left, right, is_leaf, list(range(depth + 1)))


def test_pack_bvh_refuses_too_deep():
    tris = tobj.icosphere(subdivisions=3)  # enough primitives
    ok = tpairs.pack_bvh(_chain(tpairs.TRAVERSAL_STACK), tris)
    assert ok.depth == tpairs.TRAVERSAL_STACK
    with pytest.raises(ValueError, match="traversal stack"):
        tpairs.pack_bvh(_chain(tpairs.TRAVERSAL_STACK + 1), tris)


def test_pack_bvh_refuses_quad_records():
    scene = sp.create_mesh_scene(subdivisions=1, device="cpu")
    with pytest.raises(ValueError, match="TPU tuning knob"):
        tpairs.pack_bvh(scene.bvh, scene.triangles, fanout=4)
    with pytest.raises(ValueError, match="leaf form"):
        tpairs.pack_bvh(scene.bvh, scene.triangles, form="xx")


def test_stack_size_matches_kernel_source():
    src = open(os.path.join(ROOT, "spira_tpu_torch", "csrc",
                            "bvh.cuh")).read()
    (size,) = re.findall(r"constexpr int kStackSize = (\d+);", src)
    assert int(size) == tpairs.TRAVERSAL_STACK
