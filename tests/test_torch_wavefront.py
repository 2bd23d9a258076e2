"""The wavefront estimator's nearest-hit queries against the JAX package's:
brute force, the BVH walks, the mixed sphere+triangle tree, and the
packed-BVH hook (kernel #3's plain version here) against JAX's
``make_sorted_tile_intersect`` run in interpret mode; and ``select_engine``.

Tolerances: brute force and the walks find the same winner; t within
rtol 1e-6 and atol 1e-6 (brute force, the same formulas: JAX sums the
sphere's half-b in a contraction of another order, and near a tangent
the square root of the small discriminant lifts that last bit to 5e-7)
or rtol 1e-5 (the walks recompute the winner's t by Möller–Trumbore, as
JAX does), the same hit and
material on at least 99.9% of rays (a ray grazing an edge may pick the
neighbour triangle when a last bit differs).  The hook's hits within
rtol 1e-4 / atol 1e-5: with ``grad=False`` it takes the kernel's own t
and normal (JAX's leaf test refines an approximate reciprocal; the port
divides exactly), and both forms merge in the radius-100 ground sphere,
whose c = |oc|² - r² cancels four digits, so JAX's fused multiply-add
contraction for half-b against torch's separate products moves t by up
to 5e-5 relative.

JAX's stackless ``intersect_bvh`` takes about two minutes to compile on
the CPU, so the port's is held against JAX's stack-per-ray oracle of it
and against JAX's brute force."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.accel import bvh as jbvh
from spira_tpu.accel import traverse as jtrav
from spira_tpu.accel.pairs import attach_packed as j_attach_packed
from spira_tpu.integrator import intersect as jint
from spira_tpu.kernels import bvh_megakernel as jbk
from spira_tpu_torch.accel import bvh as tbvh
from spira_tpu_torch.accel import traverse as ttrav
from spira_tpu_torch.integrator import intersect as tint
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

BRUTE_T_RTOL, BRUTE_T_ATOL = 1e-6, 1e-6
WALK_T_RTOL = 1e-5
AGREE = 0.999
KERNEL_T_RTOL, KERNEL_T_ATOL = 1e-4, 1e-5


def _port(obj):
    return sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, obj),
                               device="cpu")


@pytest.fixture(scope="module")
def mesh():
    """create_mesh_scene(subdivisions=1) with its packed tables, in both
    packages (the port's from the JAX arrays), and 1024 random rays, half
    aimed at the mesh."""
    jscene = j_attach_packed(st.create_mesh_scene(subdivisions=1))
    rng = np.random.default_rng(3)
    o = rng.uniform(-2.0, 2.0, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    aim = np.array([0.0, 0.1, 0.0], np.float32) - o[:512]
    d[:512] = aim
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jscene, _port(jscene), o, d


def _t(x):
    return torch.from_numpy(x)


def _check_hits(got, want, t_rtol, agree=1.0, t_atol=0.0):
    hit = np.asarray(want.hit)
    same = ((got.hit.numpy() == hit)
            & (got.material.numpy() == np.asarray(want.material)))
    assert same.mean() >= agree, same.mean()
    both = same & hit
    assert both.sum() > 20
    np.testing.assert_allclose(got.t.numpy()[both],
                               np.asarray(want.t)[both], rtol=t_rtol,
                               atol=t_atol)
    assert (got.t.numpy()[~got.hit.numpy()] == tint.INF).all()
    np.testing.assert_allclose(got.normal.numpy()[both],
                               np.asarray(want.normal)[both], atol=1e-5)


@pytest.mark.parametrize("which", ["spheres", "triangles", "scene"])
def test_brute_force_matches_jax(which):
    """The Cornell box (12 triangles, 2 spheres): brute force finds the
    same hits, materials and normals; misses keep material 0."""
    jscene = st.create_cornell_box()
    scene = _port(jscene)
    rng = np.random.default_rng(1)
    o = rng.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if which == "spheres":
        want = jint.intersect_spheres(jscene.spheres, o, d)
        got = tint.intersect_spheres(scene.spheres, _t(o), _t(d))
    elif which == "triangles":
        want = jint.intersect_triangles(jscene.triangles, o, d)
        got = tint.intersect_triangles(scene.triangles, _t(o), _t(d))
    else:
        want = jint.intersect_scene(jscene, o, d)
        got = tint.intersect_scene(scene, _t(o), _t(d))
    _check_hits(got, want, BRUTE_T_RTOL, t_atol=BRUTE_T_ATOL)
    np.testing.assert_array_equal(got.material.numpy(),
                                  np.asarray(want.material))


def test_bvh_walks_match_jax(mesh):
    """The stackless and stack walks over the mesh's two-level tree
    against JAX's stack walk and brute force; the port's two walks agree
    to the bit."""
    jscene, scene, o, d = mesh
    want = jtrav.intersect_bvh_stack(jscene.bvh, jscene.triangles, o, d)
    brute = jint.intersect_triangles(jscene.triangles, o, d)
    stackless = ttrav.intersect_bvh(scene.bvh, scene.triangles, _t(o),
                                    _t(d))
    stack = ttrav.intersect_bvh_stack(scene.bvh, scene.triangles, _t(o),
                                      _t(d))
    for got in (stackless, stack):
        _check_hits(got, want, WALK_T_RTOL, AGREE)
        _check_hits(got, brute, WALK_T_RTOL, AGREE)
    for f in ("t", "normal", "material", "hit"):
        torch.testing.assert_close(getattr(stackless, f), getattr(stack, f),
                                   rtol=0, atol=0)


def test_build_mixed_bvh_and_walk_match_jax(mesh):
    """build_mixed_bvh over the mesh scene's spheres and triangles equals
    JAX's array for array; the mixed walk finds JAX's hits, and
    intersect_scene takes it for a tree with spheres."""
    jscene, scene, o, d = mesh
    jtree = jbvh.build_mixed_bvh(jscene.spheres, jscene.triangles)
    tree = tbvh.build_mixed_bvh(scene.spheres, scene.triangles)
    for f in ("node_min", "node_max", "left", "right", "is_leaf",
              "prim_idx", "parent", "sibling", "is_left"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(getattr(jtree, f)), f)
    assert (tree.max_leaf, tree.n_sph) == (jtree.max_leaf, jtree.n_sph)
    want = jtrav.intersect_bvh_mixed(jtree, jscene.spheres,
                                     jscene.triangles, o, d)
    got = ttrav.intersect_bvh_mixed(tree, scene.spheres, scene.triangles,
                                    _t(o), _t(d))
    _check_hits(got, want, WALK_T_RTOL, AGREE)
    via_scene = tint.intersect_scene(dataclasses.replace(scene, bvh=tree),
                                     _t(o), _t(d))
    torch.testing.assert_close(via_scene.t, got.t, rtol=0, atol=0)


@pytest.mark.parametrize("grad", [False, True])
def test_packed_hook_matches_jax(mesh, grad):
    """One bounce's rays, 30% of them dead: the hook over the plain #3
    against JAX's hook over Pallas #3 in interpret mode (tile_h 8)."""
    jscene, scene, o, d = mesh
    alive = np.random.default_rng(5).uniform(size=o.shape[0]) > 0.3
    want = jbk.make_sorted_tile_intersect(interpret=True, tile_h=8,
                                          grad=grad)(jscene, o, d, alive)
    got = tbk.make_sorted_tile_intersect(grad=grad)(scene, _t(o), _t(d),
                                                    _t(alive))
    if grad:
        _check_hits(got, want, KERNEL_T_RTOL, AGREE, t_atol=KERNEL_T_ATOL)
        return
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.material.numpy(),
                                  np.asarray(want.material))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=KERNEL_T_RTOL, atol=KERNEL_T_ATOL)
    np.testing.assert_allclose(got.normal.numpy()[hit],
                               np.asarray(want.normal)[hit],
                               rtol=KERNEL_T_RTOL, atol=KERNEL_T_ATOL)


def test_packed_hook_refusals(mesh):
    _, scene, o, d = mesh
    o, d, alive = _t(o[:8]), _t(d[:8]), torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="attach_packed"):
        tbk.make_sorted_tile_intersect()(
            dataclasses.replace(scene, packed=None), o, d, alive)
    with pytest.raises(ValueError, match="prim_map"):
        tbk.make_sorted_tile_intersect(grad=True)(
            dataclasses.replace(scene, packed=dataclasses.replace(
                scene.packed, prim_map=None)), o, d, alive)


def _fake(device, packed=None, bvh=None, n_tris=0, n_sph=5):
    """What select_engine reads of a scene, on a named device (no card
    here)."""
    return types.SimpleNamespace(
        packed=packed, bvh=bvh, device=torch.device(device),
        triangles=types.SimpleNamespace(count=n_tris),
        spheres=types.SimpleNamespace(count=n_sph))


def test_select_engine_matches_jax_rules():
    """The cases of the JAX package's engine-dispatch tests, with cuda /
    cuda_bvh for pallas / pallas_bvh and the card for the TPU backend."""
    sphere_cpu = sp.create_scene(device="cpu")
    mesh_cpu = sp.create_mesh_scene(subdivisions=1, device="cpu")
    packed_cpu = sp.attach_packed(mesh_cpu)
    sel = sp.select_engine
    assert sel(sphere_cpu, "physical", False) == "fused"
    assert sel(sphere_cpu, "reference", False) == "wavefront"
    assert sel(sphere_cpu, "physical", True) == "fused"
    assert sel(mesh_cpu, "physical", False) == "wavefront"
    assert sel(packed_cpu, "physical", False) == "wavefront"
    assert sel(packed_cpu, "physical", True) == "wavefront"
    assert sel(sphere_cpu, "physical", False, "cuda") == "cuda"
    assert sel(sphere_cpu, "physical", False, "wavefront") == "wavefront"
    packed_card = _fake("cuda", packed=object(), bvh=object(), n_tris=400)
    assert sel(packed_card, "physical", False) == "cuda_bvh"
    assert sel(packed_card, "physical", True) == "cuda_spectral_bvh"
    assert sel(packed_card, "reference", False) == "wavefront"
    assert sel(_fake("cuda"), "physical", False) == "cuda"
    assert sel(_fake("cuda"), "physical", True) == "cuda"
    assert sel(_fake("cuda"), "reference", True) == "wavefront"
    assert sel(_fake("cuda", bvh=object(), n_tris=400), "physical",
               False) == "wavefront"
    assert sel(_fake("cpu", n_tris=33), "physical", False) == "wavefront"
    assert sel(_fake("cpu", n_sph=0), "physical", False) == "wavefront"
