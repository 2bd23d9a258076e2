"""The port's SBVH builder against the JAX package on the CPU: the trees
value-exact (every ``FlatBVH`` field, the links, ``max_leaf``) with polygon
clipping and with box clipping, every packer's tables over an SBVH
table-equal to JAX's, and the walks over duplicated references finding the
SAH tree's nearest hits (as ``tests/test_bvh.py:266-294`` holds JAX's)."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu.accel import bvh as jbvh
from spira_tpu.accel import mxu as jmxu
from spira_tpu.accel import native as jnative
from spira_tpu.accel import pairs as jpairs
from spira_tpu.accel import wide as jwide
from spira_tpu.scene import geometry as jgeom
from spira_tpu.scene import obj as jobj
from spira_tpu_torch.accel import bvh as tbvh
from spira_tpu_torch.accel import mxu as tmxu
from spira_tpu_torch.accel import native as tnative
from spira_tpu_torch.accel import pairs as tpairs
from spira_tpu_torch.accel import wide as twide
from spira_tpu_torch.accel.traverse import intersect_bvh
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.scene import geometry as tgeom
from spira_tpu_torch.scene import obj as tobj

from ._torch_native import same_native_library  # noqa: F401
from .test_torch_bvh import (BVH_FIELDS, PACKED_FIELDS, PACKED_META,
                             _assert_equal, _assert_meta)
from .test_torch_mxu import _assert_lanes_match, _assert_tables_equal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREFOIL = os.path.join(ROOT, "assets", "trefoil.obj")
#: nearest hits over the SBVH against the SAH tree of the same triangles:
#: the same triangle is found (material equal, the miss set equal); t to
#: 1e-6 absolute, since a duplicated reference is the same triangle's
#: record (the test of tests/test_bvh.py:266-294)
T_ATOL = 1e-6


def _scene(ico, load_obj, concat, name):
    if name.startswith("ico"):
        return ico(radius=1.0, subdivisions=int(name[3:]))
    if name == "trefoil":
        return load_obj(TREFOIL, material=2, center=True, normalize=True)
    return concat([ico((-0.6, 0.1, 0.0), 0.55, 2, 0),  # two_spheres
                   ico((0.8, -0.2, 0.3), 0.45, 1, 1)])


SCENES = ("ico2", "ico3", "trefoil", "two_spheres")


@pytest.fixture(scope="module")
def soups():
    """(JAX triangles, port triangles) for each scene."""
    return {name: (_scene(jobj.icosphere, jobj.load_obj_mesh,
                          jgeom.concat_triangles, name),
                   _scene(tobj.icosphere, tobj.load_obj_mesh,
                          tgeom.concat_triangles, name))
            for name in SCENES}


def _sbvh(side, tris, clip, leaf_size):
    """One side's SBVH: polygon clipping through build_sbvh_for_triangles,
    box clipping through build_sbvh_native without vertices."""
    bvh_mod, native_mod, geom = dict(
        jax=(jbvh, jnative, jgeom), port=(tbvh, tnative, tgeom))[side]
    if clip == "polygon":
        return bvh_mod.build_sbvh_for_triangles(tris, leaf_size=leaf_size)
    lo, hi = geom.triangle_bounds(tris)
    return native_mod.build_sbvh_native(np.asarray(lo), np.asarray(hi),
                                        leaf_size=leaf_size)


@pytest.fixture(scope="module")
def trees(soups):
    """(JAX SBVH, port SBVH) by (scene, clip, leaf size), built once."""
    out = {}
    for name, (jt, tt) in soups.items():
        for clip in ("polygon", "box"):
            for leaf in (4, 8):
                out[name, clip, leaf] = (_sbvh("jax", jt, clip, leaf),
                                         _sbvh("port", tt, clip, leaf))
    return out


@pytest.mark.parametrize("leaf_size", [4, 8])
@pytest.mark.parametrize("clip", ["polygon", "box"])
@pytest.mark.parametrize("name", SCENES)
def test_sbvh_equals_jax(soups, trees, name, clip, leaf_size):
    """Every FlatBVH field value for value, the links and max_leaf; the
    spatial splits duplicate references, which both sides keep."""
    jb, tb = trees[name, clip, leaf_size]
    _assert_equal(tb, jb, BVH_FIELDS)
    assert tb.max_leaf == jb.max_leaf <= leaf_size
    n = soups[name][1].count
    prim = tb.prim_idx.numpy()
    assert sorted(set(prim.tolist())) == list(range(n))
    assert len(prim) <= max(int(n * 1.8) + 8, n + 8)
    if clip == "polygon":
        assert len(prim) > n  # the splits did duplicate references


@pytest.mark.parametrize("form", ["bw", "mt"])
@pytest.mark.parametrize("name", SCENES)
def test_pack_bvh_over_sbvh_equals_jax(soups, trees, name, form):
    """The pair records, leaf rows and slot map over an SBVH, value for
    value; every slot of a leaf maps back to its reference's triangle."""
    jt, tt = soups[name]
    jb, tb = trees[name, "polygon", 4]
    port = tpairs.pack_bvh(tb, tt, form=form)
    ref = jpairs.pack_bvh(jb, jt, form=form)
    _assert_equal(port, ref, PACKED_FIELDS)
    _assert_meta(port, ref, PACKED_META)
    slots = port.prim_map.numpy()
    assert sorted(set(slots[slots >= 0].tolist())) == list(range(tt.count))
    assert (slots >= 0).sum() == tb.prim_idx.shape[0]


PACKINGS = {
    "wide": (jwide.pack_bvh16, twide.pack_bvh16, {}),
    "mxu_128": (jmxu.pack_bvh_mxu, tmxu.pack_bvh_mxu, {}),
    "mxu_32": (jmxu.pack_bvh_mxu, tmxu.pack_bvh_mxu, dict(superleaf=32)),
    "superleaf_128": (jmxu.pack_bvh_superleaf, tmxu.pack_bvh_superleaf, {}),
    "superleaf_32": (jmxu.pack_bvh_superleaf, tmxu.pack_bvh_superleaf,
                     dict(superleaf=32)),
}


@pytest.mark.parametrize("packing", sorted(PACKINGS))
@pytest.mark.parametrize("name", ["ico3", "trefoil"])
def test_wide_packers_over_sbvh_equal_jax(soups, trees, name, packing):
    """The 16-wide, MXU and superleaf tables over an SBVH equal JAX's,
    and the lane records of the superleaf kinds equal JAX's tables'."""
    jt, tt = soups[name]
    jb, tb = trees[name, "polygon", 8]
    jpack, tpack, kw = PACKINGS[packing]
    port, ref = tpack(tb, tt, **kw), jpack(jb, jt, **kw)
    _assert_tables_equal(port, ref)
    if packing != "wide":
        _assert_lanes_match(port, ref)


def _rays(n, seed):
    """Random rays, half aimed at the unit ball (tests/test_bvh.py:285-290)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (n, 3))
    d = rng.normal(size=(n, 3))
    d[::2] = rng.uniform(-0.6, 0.6, (n - n // 2, 3)) - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", SCENES)
def test_walks_over_sbvh_find_the_sah_hits(soups, trees, name):
    """The NumPy oracle over the packed SBVH, the stackless walk over the
    tree and the packed-BVH query's plain version (slot form included:
    the slot's triangle through ``prim_map``) find the nearest hits of
    the SAH tree over the same triangles, as JAX's oracle does."""
    jt, tt = soups[name]
    jb, tb = trees[name, "polygon", 4]
    sah = tbvh.build_bvh_for_triangles(tt, leaf_size=4)
    packed = {k: tpairs.pack_bvh(b, tt) for k, b in (("sah", sah),
                                                      ("sbvh", tb))}
    jpacked = jpairs.pack_bvh(jb, jt)
    o, d = _rays(64, 7)
    hits = 0
    for i in range(len(o)):
        t1, _, m1 = tpairs.traverse_packed_numpy(packed["sah"], o[i], d[i])
        t2, _, m2 = tpairs.traverse_packed_numpy(packed["sbvh"], o[i], d[i])
        t3, _, m3 = jpairs.traverse_packed_numpy(jpacked, o[i], d[i])
        assert (t2, m2) == (t3, m3), i
        if np.isfinite(t1):
            hits += 1
            assert abs(t1 - t2) < T_ATOL and m1 == m2, (i, t1, t2, m1, m2)
        else:
            assert not np.isfinite(t2), (i, t2)
    assert hits > 10

    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    walks = {k: intersect_bvh(b, tt, ot, dt) for k, b in (("sah", sah),
                                                           ("sbvh", tb))}
    assert torch.equal(walks["sah"].hit, walks["sbvh"].hit)
    assert int(walks["sah"].hit.sum()) > 10
    assert torch.equal(walks["sah"].material, walks["sbvh"].material)
    torch.testing.assert_close(walks["sbvh"].t, walks["sah"].t, rtol=0,
                               atol=T_ATOL)
    for with_slot in (False, True):
        got = {k: tbk.intersect_packed_plain(p, ot, dt, with_slot=with_slot)
               for k, p in packed.items()}
        torch.testing.assert_close(got["sbvh"][0], got["sah"][0], rtol=0,
                                   atol=T_ATOL)
        assert torch.equal(got["sbvh"][2], got["sah"][2])
        if with_slot:
            tri = {k: torch.where(g[3] >= 0, packed[k].prim_map[
                g[3].clamp(min=0).long()], -1) for k, g in got.items()}
            assert torch.equal(tri["sbvh"], tri["sah"])


def test_slot_form_hook_over_sbvh(soups, trees):
    """The wavefront's #3 hook in its slot form (``grad=True``) over a
    packed SBVH: each winner slot resolves through ``prim_map`` to the
    same triangle as over the SAH tree, so the recomputed hit is equal."""
    tt = soups["trefoil"][1]
    scenes = {}
    for key, bvh in (("sah", tbvh.build_bvh_for_triangles(tt, leaf_size=4)),
                     ("sbvh", trees["trefoil", "polygon", 4][1])):
        scenes[key] = tpairs.attach_packed(sp.make_scene(
            triangles=tt, bvh=bvh, materials=sp.make_materials(
                [dict(albedo=(0.5, 0.5, 0.5))] * 3, device="cpu")))
    o, d = (torch.from_numpy(a) for a in _rays(256, 11))
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    hook = tbk.make_sorted_tile_intersect(grad=True)
    got = {k: hook(s, o, d, alive) for k, s in scenes.items()}
    assert int(got["sah"].hit.sum()) > 20
    for f in ("hit", "material", "t", "normal"):
        assert torch.equal(getattr(got["sbvh"], f), getattr(got["sah"], f)), f


def test_missing_library_falls_back_to_sah(soups, monkeypatch, caplog):
    """Without the library both sides log a note and return the plain
    SAH builder's tree (here the NumPy median split, the library being
    absent), equal to each other."""
    jt, tt = soups["ico2"]
    monkeypatch.setattr(jnative, "_lib_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_library", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.build_sbvh_native(*tgeom.triangle_bounds(tt))
    with caplog.at_level(logging.INFO, logger=tbvh.__name__):
        got = tbvh.build_sbvh_for_triangles(tt, leaf_size=4)
    assert any(r.levelno == logging.INFO and "plain SAH" in r.message
               for r in caplog.records)
    want = jbvh.build_sbvh_for_triangles(jt, leaf_size=4)
    _assert_equal(got, want, BVH_FIELDS)
    _assert_equal(got, tbvh.build_bvh_for_triangles(tt, leaf_size=4,
                                                    use_native=False),
                  BVH_FIELDS)
    assert len(got.prim_idx) == tt.count


def test_pack_bvh_guards_hold_over_sbvh(soups, trees):
    """A leaf may reach past the triangle count (duplicated references
    make ``prim_idx`` longer) but not past ``prim_idx``; a leaf with no
    reference is still refused."""
    tt = soups["trefoil"][1]
    tb = trees["trefoil", "polygon", 4][1]
    leaves = np.nonzero(tb.is_leaf.numpy() == 1)[0]
    ends = tb.left.numpy()[leaves] + tb.right.numpy()[leaves]
    last = leaves[np.argmax(ends)]
    assert ends.max() == tb.prim_idx.shape[0] > tt.count
    tpairs.pack_bvh(tb, tt)  # the last leaf ends at len(prim_idx)
    for count in (0, int(tb.right[last]) + 1):  # empty; past prim_idx
        right = tb.right.clone()
        right[last] = count
        bad = dataclasses.replace(tb, right=right)
        with pytest.raises(ValueError, match="a leaf needs"):
            tpairs.pack_bvh(bad, tt)
