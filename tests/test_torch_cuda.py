"""The CUDA kernels against the port's plain versions, on the card: the
sphere megakernel, the packed-BVH path tracer, the packed-BVH nearest-hit
query, the spectral megakernel and spectral packed-BVH path tracer, the
adjoint kernel against autograd through the plain tracer, and the
superleaf kernels (the streaming path tracer and query, the packed-BVH
path tracer with superleaf leaves), the peak-rate probes (kernels #9 and
#10), the counting build of the packed-BVH path tracer, and the wavefront
estimator (``render_flat`` through the packed-BVH query, one launch a
bounce, with no synchronising call; ``render_with_cpu``; ``bvh_sorted``),
the mesh gradient (``render_flat_hybrid_grad_mesh``: its forward one
launch of #2 or #5, its backward #3's launches only, against the plain
hook's backward, with no synchronising call), and the command line and
its renderers (``cli render`` on the four kernel scenes, one launch each
and ``render_hdr``'s image to the bit; the adaptive renderer on the bunny
through #3, deterministic; the progressive renderer's exact resume; the
preview through one #3 launch; an inverse step through #3's slot form
with no synchronising call).

Every test here needs an NVIDIA card and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; run it there without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch.accel import pairs
from spira_tpu_torch.bench import packet_profile as pp
from spira_tpu_torch.bench import vpu_peak as vp
from spira_tpu_torch.accel.bvh import (build_bvh_for_triangles,
                                        build_sbvh_for_triangles)
from spira_tpu_torch.kernels import bvh_megakernel as bk
from spira_tpu_torch.kernels import grad_megakernel as gk
from spira_tpu_torch.kernels import megakernel as mk
from spira_tpu_torch.kernels import mxu_megakernel as xk
from spira_tpu_torch.kernels import spectral_bvh as sb
from spira_tpu_torch.kernels import spectral_fused as sf
from spira_tpu_torch.render import mesh_replay_launches
from spira_tpu_torch.scene.geometry import empty_spheres
from spira_tpu_torch.scene.obj import icosphere
from tests.test_torch_superleaf_host import (blocks_twice,
                                             chain_twice_scene,
                                             deep_tree_scene, one_block_scene,
                                             twin_block_scene,
                                             twin_mesh_scene, twin_scene)

pytestmark = pytest.mark.cuda

MEAN_REL = 0.005


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _pair(scene_fn, cam_fn, device, width, height, **kw):
    scene = getattr(sp, scene_fn)(device=device)
    cam = cam_fn(width / height, device)
    args = dict(width=width, height=height, **kw)
    kernel = mk.render_flat_megakernel(scene, cam, **args)
    plain = mk.render_flat_fused(scene, cam, **args)
    torch.cuda.synchronize()
    return kernel.cpu().numpy(), plain.cpu().numpy()


def _default(aspect, device):
    return sp.default_camera(aspect, device=device)


def _cornell(aspect, device):
    return sp.cornell_camera(aspect, device=device)


def _lens(aspect, device):
    return sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=aspect, aperture=0.2, focus_dist=3.0,
                          device=device)


# name: (scene, camera, shape, atol, share of pixel-channels within atol).
# Depth 1 sees only primary hits and raygen jitter; deeper paths may flip a
# branch where a library function differs in its last bit.
CASES = {
    "demo_d1": ("create_scene", _default,
                dict(width=256, height=128, spp=1, max_depth=1), 1e-5, 0.999),
    "demo_d4": ("create_scene", _default,
                dict(width=256, height=128, spp=8, max_depth=4), 1e-4, 0.99),
    "cornell_d6": ("create_cornell_box", _cornell,
                   dict(width=128, height=128, spp=8, max_depth=6), 1e-4,
                   0.99),
    "thin_lens_d3": ("create_scene", _lens,
                     dict(width=256, height=128, spp=4, max_depth=3), 1e-4,
                     0.99),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    scene_fn, cam_fn, shape, atol, frac = CASES[name]
    kernel, plain = _pair(scene_fn, cam_fn, cuda, seed=11, **shape)
    assert kernel.shape == (shape["width"] * shape["height"], 3)
    assert np.isfinite(kernel).all()
    np.testing.assert_allclose(kernel.mean(0), plain.mean(0), rtol=MEAN_REL)
    assert (np.abs(kernel - plain) <= atol).mean() >= frac


def test_render_goes_through_kernel(cuda):
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    assert sp.select_engine(scene, "physical", False) == "cuda"
    before = mk.render_flat_megakernel.launches
    img = sp.render(scene, cam, 128, 64, samples_per_pixel=4, max_depth=4)
    assert mk.render_flat_megakernel.launches == before + 1
    plain = sp.render(scene, cam, 128, 64, samples_per_pixel=4, max_depth=4,
                      engine="fused")
    assert mk.render_flat_megakernel.launches == before + 1
    assert img.std() > 0
    assert abs(float(img.mean()) - float(plain.mean())) <= 1.0


def test_kernel_deterministic_and_seed_sensitive(cuda):
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    kw = dict(width=128, height=16, spp=2, max_depth=2)
    a = mk.render_flat_megakernel(scene, cam, seed=5, **kw)
    b = mk.render_flat_megakernel(scene, cam, seed=5, **kw)
    c = mk.render_flat_megakernel(scene, cam, seed=6, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0


def test_kernel_wrapper_checks(cuda):
    scene = sp.create_scene(device=cuda)
    with pytest.raises(ValueError, match="camera table is on cpu"):
        mk.render_flat_megakernel(scene, sp.default_camera(2.0, device="cpu"),
                                  width=16, height=8)
    cam = sp.default_camera(2.0, device=cuda)
    with pytest.raises(ValueError, match="width, height, spp"):
        mk.render_flat_megakernel(scene, cam, width=0, height=8)
    many = dataclasses.replace(
        scene,
        spheres=sp.make_spheres([((0.0, 0.0, -5.0 - i), 0.1, 0)
                                 for i in range(800)], device=cuda),
    )
    with pytest.raises(ValueError, match="shared-memory"):
        mk.render_flat_megakernel(many, cam, width=16, height=8)


# ---------------------------------------------------------------------------
# The packed-BVH kernels
# ---------------------------------------------------------------------------

def _mesh(device, form="bw", subdivisions=2):
    scene = sp.create_mesh_scene(subdivisions=subdivisions, device=device)
    return sp.attach_packed(scene, form=form)


def _rays(n, device, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = np.array([0.0, 0.1, 0.0], np.float32) - o
    d[1::2] = rng.normal(size=(n // 2, 3))  # half aimed at the mesh
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device))


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_bvh_intersect_matches_plain(cuda, form):
    scene = _mesh(cuda, form)
    o, d = _rays(8192, cuda)
    active = torch.arange(8192, device=cuda) % 5 != 0
    before = bk.intersect_tile.launches
    got = bk.intersect_tile(scene.packed, o, d, active=active,
                            with_slot=True)
    assert bk.intersect_tile.launches == before + 1
    want = bk.intersect_packed_plain(scene.packed, o, d, active, True)
    torch.cuda.synchronize()
    hit = want[0] < 1e19
    assert 1000 < int(hit.sum()) and not hit[~active].any()
    assert torch.equal(got[0] < 1e19, hit)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def _active(n, live, device, seed=1):
    """An (n,) bool mask with about ``live`` of the rays alive, exactly one
    ("one"), none ("none"), or None (every ray, "all")."""
    if live == "all":
        return None
    mask = torch.zeros(n, dtype=torch.bool)
    if live == "one":
        mask[n // 2] = True
    elif live != "none":
        rng = np.random.default_rng(seed)
        mask = torch.from_numpy(rng.uniform(size=n) < live)
    return mask.to(device)


@pytest.mark.parametrize("live", [1.0, 0.5, 0.05, "one", "none", "all"])
@pytest.mark.parametrize("n", [1, 31, 129, 230400])
def test_bvh_intersect_bit_equal_to_plain(cuda, n, live):
    """#3 at any number of rays and live share, with and without the
    slot, twice in a row on the same workspace: each call one launch and
    equal to the plain walk to the bit."""
    scene = _mesh(cuda)
    o, d = _rays(n, cuda, seed=n)
    active = _active(n, live, cuda)
    want = bk.intersect_packed_plain(scene.packed, o, d, active, True)
    before = bk.intersect_tile.launches
    got = [bk.intersect_tile(scene.packed, o, d, active=active,
                             with_slot=True),
           bk.intersect_tile(scene.packed, o, d, active=active),
           bk.intersect_tile(scene.packed, o, d, active=active,
                             with_slot=True)]
    torch.cuda.synchronize()
    assert bk.intersect_tile.launches == before + 3
    assert len(got[1]) == 3
    for out in got:
        for name, a, b in zip(("t", "normal", "mat id", "slot"), out, want):
            assert torch.equal(a, b), name
    if live in (1.0, "all") and n > 100:
        assert int((want[0] < 1e19).sum()) > n // 10


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_bvh_intersect_ties_bit_equal_to_plain(cuda, form):
    """#3 on twinned triangles, every hit a tie at equal t: the first in
    slot order wins, as in the plain walk (material and slot equal)."""
    packed = twin_scene(form).to(cuda)
    o, d = _rays(4096, cuda, seed=3)
    active = _active(4096, 0.5, cuda)
    got = bk.intersect_tile(packed, o, d, active=active, with_slot=True)
    want = bk.intersect_packed_plain(packed, o, d, active, True)
    torch.cuda.synchronize()
    assert set(want[2][want[0] < 1e19].tolist()) == {0, 1}
    for name, a, b in zip(("t", "normal", "mat id", "slot"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_bvh_render_matches_plain(cuda, form):
    """The mesh scene (two-row leaves, a mirror) at 128x64, spp 2, depth
    4: channel means within 0.5%, 99% of pixel-channels within 1e-4."""
    scene = _mesh(cuda, form)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device=cuda)
    kw = dict(width=128, height=64, spp=2, max_depth=4, seed=3)
    kernel = bk.render_flat_bvh_megakernel(scene, cam, **kw)
    plain = bk.render_flat_bvh_fused(scene, cam, **kw)
    torch.cuda.synchronize()
    kernel, plain = kernel.cpu().numpy(), plain.cpu().numpy()
    assert kernel.shape == (128 * 64, 3) and np.isfinite(kernel).all()
    np.testing.assert_allclose(kernel.mean(0), plain.mean(0), rtol=MEAN_REL)
    assert (np.abs(kernel - plain) <= 1e-4).mean() >= 0.99


def test_bvh_render_goes_through_kernel_and_is_deterministic(cuda):
    scene = _mesh(cuda, subdivisions=1)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device=cuda)
    assert sp.select_engine(scene, "physical", False) == "cuda_bvh"
    before = bk.render_flat_bvh_megakernel.launches
    img = sp.render(scene, cam, 64, 32, samples_per_pixel=2, max_depth=3)
    assert bk.render_flat_bvh_megakernel.launches == before + 1
    assert img.std() > 0
    kw = dict(width=64, height=16, spp=2, max_depth=3)
    a = bk.render_flat_bvh_megakernel(scene, cam, seed=5, **kw)
    b = bk.render_flat_bvh_megakernel(scene, cam, seed=5, **kw)
    c = bk.render_flat_bvh_megakernel(scene, cam, seed=6, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0


def test_bvh_wrapper_refusals(cuda):
    scene = _mesh(cuda, subdivisions=1)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), device=cuda)
    kw = dict(width=16, height=8, spp=1, max_depth=1)
    deep = dataclasses.replace(scene, packed=dataclasses.replace(
        scene.packed, depth=pairs.TRAVERSAL_STACK + 1))
    with pytest.raises(ValueError, match="traversal stack"):
        bk.render_flat_bvh_megakernel(deep, cam, **kw)
    with pytest.raises(ValueError, match="attach_superleaf"):
        bk.render_flat_bvh_megakernel(scene, cam, mxu_leaf=True, **kw)
    cpu_tables = dataclasses.replace(scene, packed=scene.packed.to("cpu"))
    with pytest.raises(ValueError, match="packed pairs is on cpu"):
        bk.render_flat_bvh_megakernel(cpu_tables, cam, **kw)
    with pytest.raises(ValueError, match="camera table is on cpu"):
        bk.render_flat_bvh_megakernel(
            scene, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                  device="cpu"), **kw)
    o, d = _rays(256, cuda)
    with pytest.raises(ValueError, match="packed pairs is on cpu"):
        bk.intersect_tile(cpu_tables.packed, o, d)
    with pytest.raises(ValueError, match="dirs is on cpu"):
        bk.intersect_tile(scene.packed, o, d.cpu())
    with pytest.raises(ValueError, match="traversal stack"):
        bk.intersect_tile(deep.packed, o, d)


# ---------------------------------------------------------------------------
# The spectral kernels
# ---------------------------------------------------------------------------

# name: (scene, camera, shape, atol, share of pixel-channels within atol).
# The Cornell box's flint glass (cauchy_b 0.0042) disperses, and depth 6
# runs Russian roulette.
SPECTRAL_CASES = {
    "demo_d1": ("create_scene", _default,
                dict(width=256, height=128, spp=1, max_depth=1), 1e-5, 0.999),
    "cornell_d6": ("create_cornell_box", _cornell,
                   dict(width=128, height=128, spp=8, max_depth=6), 1e-4,
                   0.99),
    "thin_lens_d3": ("create_scene", _lens,
                     dict(width=256, height=128, spp=4, max_depth=3), 1e-4,
                     0.99),
}


def _assert_close_images(kernel, plain, atol, frac):
    torch.cuda.synchronize()
    kernel, plain = kernel.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(kernel).all() and kernel.std() > 1e-3
    np.testing.assert_allclose(kernel.mean(0), plain.mean(0), rtol=MEAN_REL)
    assert (np.abs(kernel - plain) <= atol).mean() >= frac


@pytest.mark.parametrize("name", sorted(SPECTRAL_CASES))
def test_spectral_kernel_matches_plain(cuda, name):
    scene_fn, cam_fn, shape, atol, frac = SPECTRAL_CASES[name]
    scene = getattr(sp, scene_fn)(device=cuda)
    cam = cam_fn(shape["width"] / shape["height"], cuda)
    kernel = sf.render_flat_spectral_megakernel(scene, cam, seed=11, **shape)
    plain = sf.render_flat_fused_spectral(scene, cam, seed=11, **shape)
    assert kernel.shape == (shape["width"] * shape["height"], 3)
    _assert_close_images(kernel, plain, atol, frac)


def _dispersive_mesh(device, form="bw"):
    """A 20-triangle icosphere over a ground sphere, a light, and a
    dispersive glass sphere (cauchy_b 0.01) on the specular lobe."""
    mesh = icosphere(center=(0.0, 0.3, 0.0), radius=0.6, subdivisions=0,
                     material=0)
    materials = sp.make_materials([
        dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
        dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
        dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0, ior=1.5,
             transmission=1.0, cauchy_b=0.01),
    ], device="cpu")
    spheres = sp.make_spheres([((0.0, -100.5, 0.0), 100.0, 1),
                               ((0.0, 5.0, 0.0), 1.0, 2),
                               ((0.9, 0.0, 0.6), 0.35, 3)], device="cpu")
    scene = sp.make_scene(spheres=spheres, triangles=mesh,
                          materials=materials,
                          bvh=build_bvh_for_triangles(mesh))
    return sp.attach_packed(scene, form=form).to(device)


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_spectral_bvh_kernel_matches_plain(cuda, form):
    """The dispersive icosphere scene at 128x64, spp 4, depth 6, and the
    mesh scene (two-row leaves, a mirror) at 128x64, spp 2, depth 4."""
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device=cuda)
    for scene, kw in ((_dispersive_mesh(cuda, form),
                       dict(width=128, height=64, spp=4, max_depth=6)),
                      (_mesh(cuda, form),
                       dict(width=128, height=64, spp=2, max_depth=4))):
        before = sb.render_flat_spectral_bvh_megakernel.launches
        kernel = sb.render_flat_spectral_bvh_megakernel(scene, cam, seed=3,
                                                        **kw)
        assert sb.render_flat_spectral_bvh_megakernel.launches == before + 1
        plain = sb.render_flat_spectral_bvh_fused(scene, cam, seed=3, **kw)
        _assert_close_images(kernel, plain, 1e-4, 0.99)


# the mesh path tracers' split at spp that do not divide a warp or a block,
# on a frame whose rows do not divide a block: (kernel, plain version)
MESH_TRACERS = {
    "bvh": (bk.render_flat_bvh_megakernel, bk.render_flat_bvh_fused),
    "spectral_bvh": (sb.render_flat_spectral_bvh_megakernel,
                     sb.render_flat_spectral_bvh_fused),
}


@pytest.mark.parametrize("spp", [1, 3, 17])
@pytest.mark.parametrize("form", ["bw", "mt"])
@pytest.mark.parametrize("tracer", sorted(MESH_TRACERS))
def test_mesh_tracer_bit_equal_to_plain_ragged(cuda, tracer, form, spp):
    """#2 and #5 on the mesh scene at 37x23, depth 4: equal to the plain
    version to the bit (each pixel's samples traced on their own threads
    and summed in sample order), one launch."""
    kernel_fn, plain_fn = MESH_TRACERS[tracer]
    scene = _mesh(cuda, form)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=spp, max_depth=4, seed=9)
    before = kernel_fn.launches
    kernel = kernel_fn(scene, cam, **kw)
    assert kernel_fn.launches == before + 1
    plain = plain_fn(scene, cam, **kw)
    torch.cuda.synchronize()
    assert kernel.shape == (37 * 23, 3) and kernel.std() > 1e-3
    assert torch.equal(kernel, plain)


@pytest.mark.parametrize("tracer", sorted(MESH_TRACERS))
def test_mesh_tracer_deep_tree_bit_equal_to_plain(cuda, tracer):
    """A pair tree 128 records deep (the stack's limit), on which a ray
    down its middle stacks a far child at every level: #2 and #5 at 32x24,
    spp 2, depth 3, and #3 on the primary rays, equal to the plain
    versions to the bit."""
    kernel_fn, plain_fn = MESH_TRACERS[tracer]
    scene = deep_tree_scene(pairs.TRAVERSAL_STACK, cuda)
    assert scene.packed.depth == pairs.TRAVERSAL_STACK
    cam = sp.make_camera((0.0, 0.0, 2.0), (0.0, 0.0, 0.0),
                         aspect_ratio=32 / 24, vfov=20.0, device=cuda)
    kw = dict(width=32, height=24, spp=2, max_depth=3, seed=4)
    kernel = kernel_fn(scene, cam, **kw)
    plain = plain_fn(scene, cam, **kw)
    torch.cuda.synchronize()
    assert kernel.std() > 1e-3
    assert torch.equal(kernel, plain)
    o = cam.origin.expand(256, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.rand(256, 3, generator=torch.Generator().manual_seed(2))
        .to(cuda) * torch.tensor([0.02, 0.02, 0.0], device=cuda)
        - torch.tensor([0.01, 0.01, 1.0], device=cuda), dim=1)
    got = bk.intersect_tile(scene.packed, o, d, with_slot=True)
    want = bk.intersect_packed_plain(scene.packed, o, d, with_slot=True)
    assert (want[3] == 0).all()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _sbvh_mesh(device, form="bw"):
    """The mesh scene (two icospheres, a mirror) with its two-level SAH
    tree, and the same scene over an SBVH of its triangles (references
    duplicated by spatial splits), both packed, on ``device``."""
    scene = sp.create_mesh_scene(subdivisions=2, device="cpu")
    sbvh = build_sbvh_for_triangles(scene.triangles, leaf_size=4)
    assert sbvh.prim_idx.shape[0] > scene.triangles.count
    return (sp.attach_packed(scene, form=form).to(device),
            sp.attach_packed(dataclasses.replace(scene, bvh=sbvh),
                             form=form).to(device))


@pytest.mark.parametrize("form", ["bw", "mt"])
@pytest.mark.parametrize("tracer", sorted(MESH_TRACERS))
def test_mesh_tracer_over_sbvh_bit_equal_to_plain(cuda, tracer, form):
    """#2 and #5 over an SBVH at 37x23, spp 3, depth 4: one launch, equal
    to the plain version to the bit, and over the same triangles' SAH
    tree within the image tolerance of the kernel tests (the walks find
    the same triangles in another order)."""
    kernel_fn, plain_fn = MESH_TRACERS[tracer]
    sah, sbvh = _sbvh_mesh(cuda, form)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=9)
    before = kernel_fn.launches
    kernel = kernel_fn(sbvh, cam, **kw)
    assert kernel_fn.launches == before + 1
    plain = plain_fn(sbvh, cam, **kw)
    torch.cuda.synchronize()
    assert kernel.shape == (37 * 23, 3) and kernel.std() > 1e-3
    assert torch.equal(kernel, plain)
    _assert_close_images(kernel, kernel_fn(sah, cam, **kw), 1e-4, 0.99)


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_bvh_intersect_over_sbvh(cuda, form):
    """#3 over an SBVH: equal to its plain version to the bit, slot
    included, and the SAH tree's nearest hits: the same hit set and
    material ids, t within 1e-6 relative, each slot's triangle
    (``prim_map``) the same but where two triangles tie."""
    sah, sbvh = _sbvh_mesh(cuda, form)
    o, d = _rays(8192, cuda, seed=5)
    active = _active(8192, 0.5, cuda)
    before = bk.intersect_tile.launches
    got = bk.intersect_tile(sbvh.packed, o, d, active=active, with_slot=True)
    assert bk.intersect_tile.launches == before + 1
    want = bk.intersect_packed_plain(sbvh.packed, o, d, active, True)
    ref = bk.intersect_tile(sah.packed, o, d, active=active, with_slot=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "normal", "mat id", "slot"), got, want):
        assert torch.equal(a, b), name
    hit = ref[0] < 1e19
    assert int(hit.sum()) > 1000 and torch.equal(got[0] < 1e19, hit)
    assert torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)
    tri = [p.prim_map[s.clamp(min=0).long()][hit]
           for p, s in ((sbvh.packed, got[3]), (sah.packed, ref[3]))]
    assert (tri[0] == tri[1]).float().mean() >= 0.999


# the brute-force path tracers on ragged frames: (kernel, plain version)
BRUTE_TRACERS = {
    "megakernel": (mk.render_flat_megakernel, mk.render_flat_fused),
    "spectral": (sf.render_flat_spectral_megakernel,
                 sf.render_flat_fused_spectral),
}
BRUTE_SCENES = {"demo": ("create_scene", _default),
                "cornell": ("create_cornell_box", _cornell)}


@pytest.mark.parametrize("spp", [1, 3, 17])
@pytest.mark.parametrize("scene_name", sorted(BRUTE_SCENES))
@pytest.mark.parametrize("tracer", sorted(BRUTE_TRACERS))
def test_brute_tracer_bit_equal_to_plain_ragged(cuda, tracer, scene_name,
                                                spp):
    """#1 and #4 on the demo and the Cornell box at 37x23, depth 4: equal
    to the plain version to the bit (the records gathered in the kernel
    equal pack_tables' and pack_scene_spectral's), one launch."""
    kernel_fn, plain_fn = BRUTE_TRACERS[tracer]
    scene_fn, cam_fn = BRUTE_SCENES[scene_name]
    scene = getattr(sp, scene_fn)(device=cuda)
    cam = cam_fn(37 / 23, cuda)
    kw = dict(width=37, height=23, spp=spp, max_depth=4, seed=9)
    before = kernel_fn.launches
    kernel = kernel_fn(scene, cam, **kw)
    assert kernel_fn.launches == before + 1
    plain = plain_fn(scene, cam, **kw)
    torch.cuda.synchronize()
    assert kernel.shape == (37 * 23, 3) and kernel.std() > 1e-3
    assert torch.equal(kernel, plain)


def _device_ops(fn, runs=3):
    """The device operations of one ``fn()`` call by kind (kernel, memcpy,
    memset), from torch.profiler over ``runs`` calls after a warm-up, in a
    window that a throwaway kernel opens: once the process has traced a
    long stream of kernels, a session loses the record of the first
    kernel it sees (``timing.profile_window``)."""
    from spira_tpu_torch.bench.timing import device_events, profile_window

    fn()
    torch.cuda.synchronize()
    with profile_window() as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = dict(kernel=0, memcpy=0, memset=0)
    for e in device_events(prof):
        kind = ("memcpy" if e.name.startswith("Memcpy") else "memset"
                if e.name.startswith("Memset") else "kernel")
        ops[kind] += 1
    return {k: v / runs for k, v in ops.items()}


def test_brute_frames_launch_what_the_design_states(cuda):
    """One forward frame of #1 is its gather and its render launch (given
    the packed tables, as the differentiable step's forward is, the render
    alone); one of #4 the two Chebyshev fits, the render launch and the
    three ops of the XYZ to sRGB product.  Neither copies anything between
    host and card."""
    scene = sp.create_cornell_box(device=cuda)
    cam = sp.cornell_camera(2.0, device=cuda)
    kw = dict(width=64, height=32, spp=2, max_depth=3)
    ops = _device_ops(lambda: mk.render_flat_megakernel(scene, cam, **kw))
    assert ops == dict(kernel=2, memcpy=0, memset=0)
    tables = [t.contiguous() for t in mk.pack_tables(scene, cam)]
    ops = _device_ops(lambda: mk.render_flat_megakernel(
        scene, cam, tables=tables, **kw))
    assert ops == dict(kernel=1, memcpy=0, memset=0)
    ops = _device_ops(lambda: sf.render_flat_spectral_megakernel(
        scene, cam, **kw))
    assert ops["kernel"] <= 6 and ops["memcpy"] == 0 and ops["memset"] == 0


def _long_trace(n=50_000):
    """One profiled session over ``n`` small kernels; the kernel records
    it kept."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def test_frame_ops_counted_alike_after_a_long_trace(cuda):
    """The count of the test above after this process traced 50,000
    kernels in one session (as a wavefront frame's profile does): a
    session then loses its first kernel record, which the window's
    opening kernel takes, so #1's frame still counts its two kernels."""
    assert _long_trace() == 50_000
    scene = sp.create_cornell_box(device=cuda)
    cam = sp.cornell_camera(2.0, device=cuda)
    kw = dict(width=64, height=32, spp=2, max_depth=3)
    for _ in range(3):
        ops = _device_ops(lambda: mk.render_flat_megakernel(scene, cam,
                                                            **kw))
        assert ops == dict(kernel=2, memcpy=0, memset=0)


def test_frames_do_not_synchronise(cuda):
    """A frame of #1, #2, #4 and #5 enqueues its work and returns: none
    waits for the stream (the device constants are built by a first
    call)."""
    cornell = sp.create_cornell_box(device=cuda)
    mesh = _dispersive_mesh(cuda)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device=cuda)
    kw = dict(width=64, height=32, spp=2, max_depth=3)
    frames = (
        lambda: mk.render_flat_megakernel(cornell, cam, **kw),
        lambda: bk.render_flat_bvh_megakernel(mesh, cam, **kw),
        lambda: sf.render_flat_spectral_megakernel(cornell, cam, **kw),
        lambda: sb.render_flat_spectral_bvh_megakernel(mesh, cam, **kw),
    )
    want = [f() for f in frames]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [f() for f in frames]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_spectral_bvh_kernel_without_spheres(cuda):
    scene = dataclasses.replace(_dispersive_mesh(cuda),
                                spheres=empty_spheres(cuda))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device=cuda)
    kw = dict(width=64, height=32, spp=2, max_depth=3, seed=2)
    _assert_close_images(
        sb.render_flat_spectral_bvh_megakernel(scene, cam, **kw),
        sb.render_flat_spectral_bvh_fused(scene, cam, **kw), 1e-4, 0.99)


def test_spectral_render_goes_through_kernels_and_is_deterministic(cuda):
    """render(spectral=True) on CUDA scenes launches the spectral kernels
    and no RGB kernel; the kernels repeat bit for bit under one seed."""
    cornell = sp.create_cornell_box(device=cuda)
    mesh = _dispersive_mesh(cuda)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device=cuda)
    assert sp.select_engine(cornell, "physical", True) == "cuda"
    assert sp.select_engine(mesh, "physical", True) == "cuda_spectral_bvh"
    counters = (mk.render_flat_megakernel, bk.render_flat_bvh_megakernel,
                sf.render_flat_spectral_megakernel,
                sb.render_flat_spectral_bvh_megakernel)
    for scene, launched in ((cornell, 2), (mesh, 3)):
        before = [f.launches for f in counters]
        img = sp.render(scene, cam, 64, 32, samples_per_pixel=2,
                        max_depth=3, spectral=True)
        after = [f.launches for f in counters]
        assert [a - b for a, b in zip(after, before)] == [
            int(k == launched) for k in range(4)]
        assert img.std() > 0
    kw = dict(width=64, height=16, spp=2, max_depth=3)
    for fn, scene in ((sf.render_flat_spectral_megakernel, cornell),
                      (sb.render_flat_spectral_bvh_megakernel, mesh)):
        a = fn(scene, cam, seed=5, **kw)
        b = fn(scene, cam, seed=5, **kw)
        c = fn(scene, cam, seed=6, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 0


def test_spectral_wrapper_refusals(cuda):
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), device=cuda)
    kw = dict(width=16, height=8, spp=1, max_depth=1)
    scene = sp.create_scene(device=cuda)
    verts = np.array([[i, i % 2, -2.0] for i in range(35)], np.float32)
    faces = np.array([[i, i + 1, i + 2] for i in range(33)])
    big = dataclasses.replace(
        scene, triangles=sp.make_triangles(verts, faces, 0, device=cuda))
    with pytest.raises(ValueError, match="at most 32"):
        sf.render_flat_spectral_megakernel(big, cam, **kw)
    with pytest.raises(ValueError, match="camera table is on cpu"):
        sf.render_flat_spectral_megakernel(
            scene, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                  device="cpu"), **kw)
    mesh = _dispersive_mesh(cuda)
    deep = dataclasses.replace(mesh, packed=dataclasses.replace(
        mesh.packed, depth=pairs.TRAVERSAL_STACK + 1))
    with pytest.raises(ValueError, match="traversal stack"):
        sb.render_flat_spectral_bvh_megakernel(deep, cam, **kw)
    cpu_tables = dataclasses.replace(mesh, packed=mesh.packed.to("cpu"))
    with pytest.raises(ValueError, match="packed pairs is on cpu"):
        sb.render_flat_spectral_bvh_megakernel(cpu_tables, cam, **kw)


# ---------------------------------------------------------------------------
# The adjoint kernel
# ---------------------------------------------------------------------------

def _inside_light(aspect, device):
    """Inside the demo's emissive sphere: every lane of every warp adds to
    that one record at every bounce."""
    return sp.make_camera((0.0, 5.0, 0.0), (0.0, 5.0, -1.0),
                          aspect_ratio=aspect, device=device)


# name: (scene, camera, shape, grad_spp, loss mode).  Limits: the loss
# within 1e-5 relative, each table's gradient within 1e-3 relative L2 of
# the plain autograd backward (float atomics sum in another order).
GRAD_CASES = {
    "demo_vjp": ("create_scene", _default,
                 dict(width=128, height=64, spp=4, max_depth=4), 4, False),
    "demo_loss_grad_spp1": ("create_scene", _default,
                            dict(width=128, height=64, spp=4, max_depth=4),
                            1, True),
    "thin_lens_vjp": ("create_scene", _lens,
                      dict(width=128, height=64, spp=2, max_depth=3), 2,
                      False),
    "cornell_d6_vjp": ("create_cornell_box", _cornell,
                       dict(width=64, height=64, spp=2, max_depth=6), 2,
                       False),
    # 37 * 19 * 3 = 2,109 replayed samples: the last block is ragged, and
    # a warp's lanes straddle pixels
    "ragged_grad_spp3_vjp": ("create_scene", _default,
                             dict(width=37, height=19, spp=3, max_depth=4),
                             3, False),
    # the tape's full depth: 96 KB of tape a block, over the 48 KB that a
    # launch gets without opting in
    "thin_lens_d16_vjp": ("create_scene", _lens,
                          dict(width=64, height=32, spp=2, max_depth=16), 2,
                          False),
    "exclusive_uv_vjp": ("create_scene", _default,
                         dict(width=128, height=64, spp=2, max_depth=4,
                              inclusive_uv=False), 2, False),
    "inside_light_loss": ("create_scene", _inside_light,
                          dict(width=64, height=32, spp=4, max_depth=4), 4,
                          True),
}


def _rel_l2(kernel, plain):
    den = float(torch.linalg.norm(plain))
    num = float(torch.linalg.norm(kernel - plain))
    return num / den if den > 0 else num


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_grad_kernel_matches_plain(cuda, name):
    scene_fn, cam_fn, shape, grad_spp, loss_mode = GRAD_CASES[name]
    scene = getattr(sp, scene_fn)(device=cuda)
    cam = cam_fn(shape["width"] / shape["height"], cuda)
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    g = torch.Generator().manual_seed(1)
    pix = torch.rand(shape["width"] * shape["height"], 3, generator=g)
    kw = dict(loss_mode=loss_mode, grad_spp=grad_spp, seed=3, **shape)
    before = gk.render_grad_megakernel.launches
    loss_k, *grads_k = gk.render_grad_megakernel(scene, cam, tables,
                                                 pix.to(cuda), **kw)
    assert gk.render_grad_megakernel.launches == before + 1
    loss_p, *grads_p = gk.grad_tables_plain(scene, cam, tables, pix.to(cuda),
                                            **kw)
    torch.cuda.synchronize()
    if loss_mode:
        assert abs(float(loss_k) / float(loss_p) - 1.0) <= 1e-5
    else:
        assert loss_k is None
    for k, p in zip(grads_k, grads_p):
        assert k.shape == p.shape and torch.isfinite(k).all()
        assert _rel_l2(k, p) <= 1e-3
    assert float(grads_k[1].abs().max()) > 0


def test_loss_mode_loss_is_the_forward_kernels_mse(cuda):
    """Loss mode's forward kernel renders what kernel #1 renders: its loss
    is the MSE of #1's image against the same target, same seed, within
    1e-6 relative (float32 per-pixel sums, double block sums)."""
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    shape = dict(width=128, height=64, spp=4, max_depth=4, seed=5)
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    g = torch.Generator().manual_seed(2)
    target = torch.rand(128 * 64, 3, generator=g).to(cuda)
    before = gk.loss_forward.launches
    loss, *_ = gk.render_grad_megakernel(scene, cam, tables, target,
                                         loss_mode=True, grad_spp=2, **shape)
    assert gk.loss_forward.launches == before + 1
    img = mk.render_flat_megakernel(scene, cam, **shape)
    mse = float(((img.double() - target.double()) ** 2).mean())
    assert abs(float(loss) / mse - 1.0) <= 1e-6


@pytest.mark.parametrize("grad_spp", [16, 4])
def test_step_launches_one_forward_and_one_vjp(cuda, grad_spp):
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    emission = scene.materials.emission.clone().requires_grad_()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, emission=emission))
    counts = (mk.render_flat_megakernel, gk.render_grad_megakernel,
              gk.loss_forward)
    before = [f.launches for f in counts]
    img = sp.render_flat_hybrid_grad(scene, cam, width=64, height=32,
                                     spp=16, max_depth=4, grad_spp=grad_spp)
    ((img - 0.3) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 1, 0]
    assert torch.isfinite(emission.grad).all()


def test_hybrid_step_launches_the_kernels_only(cuda):
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    albedo = scene.materials.albedo.clone().requires_grad_()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=albedo))
    counts = (mk.render_flat_megakernel, gk.render_grad_megakernel)
    before = [f.launches for f in counts]
    mk.render_flat_fused.calls = 0
    img = sp.render_flat_hybrid_grad(scene, cam, width=128, height=64,
                                     spp=4, max_depth=4, grad_spp=2)
    ((img - 0.3) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [1, 1]
    assert mk.render_flat_fused.calls == 0
    assert torch.isfinite(albedo.grad).all()
    assert (albedo.grad[:2].abs().amax(dim=1) > 0).all()
    loss, d_scene, d_cam = sp.render_mse_loss_and_grads(
        sp.create_scene(device=cuda), cam, torch.full((128 * 64, 3), 0.3,
                                                      device=cuda),
        width=128, height=64, spp=2, max_depth=3)
    assert counts[1].launches == before[1] + 2
    assert torch.isfinite(loss) and torch.isfinite(d_cam.origin).all()
    assert d_scene.materials.albedo.device.type == "cuda"


def test_grad_wrapper_refusals(cuda):
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    pix = torch.zeros(16 * 8, 3, device=cuda)
    kw = dict(width=16, height=8, spp=2, grad_spp=2, max_depth=2)
    with pytest.raises(ValueError, match="tape"):
        gk.render_grad_megakernel(scene, cam, tables, pix, loss_mode=False,
                                  **dict(kw, max_depth=17))
    with pytest.raises(ValueError, match="grad_spp"):
        gk.render_grad_megakernel(scene, cam, tables, pix, loss_mode=True,
                                  **dict(kw, grad_spp=3))
    with pytest.raises(ValueError, match="target/cotangent is on cpu"):
        gk.render_grad_megakernel(scene, cam, tables, pix.cpu(),
                                  loss_mode=True, **kw)
    with pytest.raises(ValueError, match="float32 \\(128, 3\\)"):
        gk.render_grad_megakernel(scene, cam, tables, pix[:5],
                                  loss_mode=True, **kw)
    with pytest.raises(ValueError, match="camera table is on cpu"):
        gk.render_grad_megakernel(scene, cam, [tables[0].cpu(), *tables[1:]],
                                  pix, loss_mode=True, **kw)
    # 2,000 spheres: 256,000 bytes of tables and gradients
    many = dataclasses.replace(
        scene,
        spheres=sp.make_spheres([((0.0, 0.0, -5.0 - i), 0.1, 0)
                                 for i in range(2000)], device=cuda),
    )
    big = [t.detach().contiguous() for t in mk.pack_tables(many, cam)]
    with pytest.raises(ValueError, match="shared-memory"):
        gk.render_grad_megakernel(many, cam, big, pix, loss_mode=False,
                                  **kw)


# ---------------------------------------------------------------------------
# The superleaf kernels
# ---------------------------------------------------------------------------

def _superleaf_scenes(device, subdivisions=2):
    """The mesh scene with its row tables and each superleaf packing."""
    rows = _mesh(device, subdivisions=subdivisions)
    return rows, sp.attach_mxu(rows), sp.attach_superleaf(rows)


def test_mxu_intersect_matches_plain(cuda):
    """Kernel #8 against ``intersect_mxu_plain``: the same lane test in the
    same order, so bit for bit; one launch; the packed-BVH query finds the
    same hits."""
    rows, stream, _ = _superleaf_scenes(cuda)
    o, d = _rays(8192, cuda, seed=4)
    before = xk.intersect_tile_mxu.launches
    got = xk.intersect_tile_mxu(stream.wide, o, d)
    assert xk.intersect_tile_mxu.launches == before + 1
    want = xk.intersect_mxu_plain(stream.wide, o, d)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = got[0] < 1e19
    assert 1000 < int(hit.sum()) < 8192
    # another leaf test of the same triangles (Plücker against
    # Baldwin–Weber): t to rtol 1e-4 / atol 1e-5, as the CPU tests hold the
    # two walks; a ray through an edge may fall to either side, so the miss
    # sets and material ids agree but for a 1e-3 share
    ref = bk.intersect_tile(rows.packed, o, d)
    both = hit & (ref[0] < 1e19)
    assert float(((ref[0] < 1e19) != hit).float().mean()) <= 1e-3
    torch.testing.assert_close(got[0][both], ref[0][both], rtol=1e-4,
                               atol=1e-5)
    assert float((got[2] == ref[2]).float().mean()) >= 0.999


@pytest.mark.parametrize("engine", ["cuda_mxu", "cuda_bvh_mxu"])
def test_mxu_render_matches_plain(cuda, engine):
    """Kernels #7 and #2b at 128x64, spp 2, depth 4 against their plain
    versions, one launch each; channel means within 0.5% and 99% of
    pixel-channels within 1e-4 of the plain version and of cuda_bvh's
    image (same PCG stream, another intersector)."""
    rows, stream, walk = _superleaf_scenes(cuda)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device=cuda)
    kw = dict(width=128, height=64, spp=2, max_depth=4, seed=3)
    if engine == "cuda_mxu":
        scene, fn = stream, xk.render_flat_mxu_megakernel
        plain = xk.render_flat_mxu_fused(scene, cam, **kw)
    else:
        scene, fn = walk, bk.render_flat_bvh_mxu_megakernel
        plain = bk.render_flat_bvh_fused(scene, cam, mxu_leaf=True, **kw)
    before = fn.launches
    kernel = fn(scene, cam, **kw)
    assert fn.launches == before + 1
    _assert_close_images(kernel, plain, 1e-4, 0.99)
    _assert_close_images(kernel, bk.render_flat_bvh_megakernel(rows, cam,
                                                               **kw),
                         1e-4, 0.99)


def test_mxu_engines_go_through_kernels_and_are_deterministic(cuda):
    """render() on the superleaf engines launches their kernel once and no
    other; ``engine="auto"`` keeps cuda_bvh; one seed repeats bit for bit,
    another differs."""
    rows, stream, walk = _superleaf_scenes(cuda, subdivisions=1)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device=cuda)
    assert sp.select_engine(walk, "physical", False) == "cuda_bvh"
    counters = (bk.render_flat_bvh_megakernel, xk.render_flat_mxu_megakernel,
                bk.render_flat_bvh_mxu_megakernel)
    for scene, engine, launched in ((stream, "cuda_mxu", 1),
                                    (walk, "cuda_bvh_mxu", 2),
                                    (rows, "cuda_mxu", 1)):  # attaches
        before = [f.launches for f in counters]
        img = sp.render(scene, cam, 64, 32, samples_per_pixel=2,
                        max_depth=3, engine=engine)
        after = [f.launches for f in counters]
        assert [a - b for a, b in zip(after, before)] == [
            int(k == launched) for k in range(3)]
        assert img.std() > 0
    kw = dict(width=64, height=16, spp=2, max_depth=3)
    for fn, scene in ((xk.render_flat_mxu_megakernel, stream),
                      (bk.render_flat_bvh_mxu_megakernel, walk)):
        a = fn(scene, cam, seed=5, **kw)
        b = fn(scene, cam, seed=5, **kw)
        c = fn(scene, cam, seed=6, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 0


def test_mxu_wrapper_refusals(cuda):
    rows, stream, walk = _superleaf_scenes(cuda, subdivisions=1)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), device=cuda)
    kw = dict(width=16, height=8, spp=1, max_depth=1)
    deep = dataclasses.replace(walk, wide=dataclasses.replace(
        walk.wide, depth=pairs.TRAVERSAL_STACK + 1))
    with pytest.raises(ValueError, match="traversal stack"):
        bk.render_flat_bvh_mxu_megakernel(deep, cam, **kw)
    with pytest.raises(ValueError, match="attach_mxu"):
        xk.render_flat_mxu_megakernel(rows, cam, **kw)
    cpu_tables = dataclasses.replace(stream, wide=stream.wide.to("cpu"))
    with pytest.raises(ValueError, match="superleaf coeff_uv is on cpu"):
        xk.render_flat_mxu_megakernel(cpu_tables, cam, **kw)
    o, d = _rays(256, cuda)
    with pytest.raises(ValueError, match="superleaf coeff_uv is on cpu"):
        xk.intersect_tile_mxu(cpu_tables.wide, o, d)
    with pytest.raises(ValueError, match="dirs is on cpu"):
        xk.intersect_tile_mxu(stream.wide, o, d.cpu())
    with pytest.raises(ValueError, match="row leaves"):
        bk.intersect_tile(walk.wide, o, d)


def _stream_tables(kind, device):
    """Streaming tables (on ``device``) for the bit-for-bit card tests of
    #7 and #8, and whether the test expects #7's staged route.

    * ``mesh``: the 1,600-triangle mesh, 19 blocks (not a multiple of the
      ring's stages), one of them full (128 real lanes);
    * ``one_block``: the 80-triangle icosphere under one cut, one block;
    * ``five_blocks``: the mesh at subdivision 1, 5 blocks;
    * ``twins``: every triangle twice, in two lanes of one block;
    * ``blocks_twice``: the mesh's blocks followed by a copy of each, the
      copies' material ids raised: ties across two blocks;
    * ``large``: the mesh at subdivision 4, 5,440 lanes, whose records do
      not fit a block's shared memory: #7's read-only route.
    """
    if kind == "twins":
        tw = twin_mesh_scene()
        return sp.attach_mxu(tw).wide.to(device), True
    if kind == "one_block":
        tris = icosphere(material=0, subdivisions=1)
        scene = sp.make_scene(triangles=tris, materials=sp.make_materials(
            [dict(albedo=(0.7, 0.3, 0.3))], device="cpu"),
            bvh=build_bvh_for_triangles(tris, leaf_size=4, use_native=False))
        return sp.attach_mxu(scene).wide.to(device), True
    sub = dict(mesh=3, five_blocks=1, blocks_twice=1, large=4)[kind]
    tables = sp.attach_mxu(sp.create_mesh_scene(subdivisions=sub,
                                                device="cpu")).wide
    if kind == "blocks_twice":
        tables = blocks_twice(tables)
    return tables.to(device), kind != "large"


STREAM_TABLES = ("mesh", "one_block", "five_blocks", "twins",
                 "blocks_twice", "large")


@pytest.mark.parametrize("kind", STREAM_TABLES)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 8193])
def test_mxu_intersect_bits(cuda, kind, n):
    """#8 (lane records, several rays a thread, a ring of bulk copies)
    equal to ``intersect_mxu_plain`` to the bit on ray counts around the
    block's rays and on every table of :func:`_stream_tables`; one launch
    a call (none for 0 rays, which return empty)."""
    tables, _ = _stream_tables(kind, cuda)
    lanes = tables.lanes
    blocks = lanes.offsets.numel() - 1
    if kind == "mesh":
        assert blocks == 19 and lanes.max_lanes == 128
    if kind == "one_block":
        assert blocks == 1
    if kind == "five_blocks":
        assert blocks == 5
    o, d = _rays(max(n, 1), cuda, seed=n)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    before = xk.intersect_tile_mxu.launches
    got = xk.intersect_tile_mxu(tables, o, d)
    assert xk.intersect_tile_mxu.launches == before + 1
    want = xk.intersect_mxu_plain(tables, o, d)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    if n >= 255:
        assert int((got[0] < 1e19).sum()) > 0
    if kind == "blocks_twice" and n:  # the copies (ids + 8) never win
        assert int(got[2].max()) < 8


def test_mxu_intersect_parallel_rays(cuda):
    """Rays parallel to axis-aligned triangles (det exactly 0, or
    |det| <= 1e-12) and rays that hit them, through #8 and its plain
    version, equal to the bit: the parallel ones miss."""
    tables = sp.attach_mxu(deep_tree_scene(8)).wide.to(cuda)
    rng = np.random.default_rng(3)
    n = 1024
    o = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                        rng.uniform(-5.0, 0.0, (n, 1))], 1)
    d = np.concatenate([rng.normal(size=(n, 2)), np.zeros((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 4, 2] = 1e-14  # |det| <= 1e-12 on triangles of unit area
    d[n // 2:] = [0.0, 0.0, -1.0]  # the other half hits, from above
    o[n // 2:] = np.concatenate([rng.uniform(-0.3, 0.3, (n // 2, 2)),
                                 np.ones((n // 2, 1))], 1)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
    got = xk.intersect_tile_mxu(tables, o, d)
    want = xk.intersect_mxu_plain(tables, o, d)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0][: n // 2] == 1e20).all() and (got[0][n // 2:] < 1e19).all()


@pytest.mark.parametrize("kind", STREAM_TABLES)
def test_mxu_render_bits_on_each_route(cuda, kind):
    """#7 equal to ``render_flat_mxu_fused`` to the bit on a ragged frame
    at spp 3 and depth 4, on the route its size picks (staged where the
    records fit, the read-only route for ``large``), one launch counted on
    that route; on the staged tables the read-only route too, to the same
    bits."""
    tables, staged = _stream_tables(kind, cuda)
    scene = dataclasses.replace(sp.create_mesh_scene(subdivisions=1,
                                                     device=cuda),
                                wide=tables)
    if kind == "blocks_twice":  # the copies' material ids exist
        scene = dataclasses.replace(scene, materials=sp.make_materials(
            [dict(albedo=(0.2 + 0.05 * k, 0.5, 0.8 - 0.05 * k))
             for k in range(16)], device=cuda))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=5)
    route = "staged" if staged else "global"
    lanes = tables.lanes
    assert xk.choose_route(scene, lanes, lanes.offsets.numel() - 1,
                           kw["spp"]) == route
    before = (xk.render_flat_mxu_megakernel.launches,
              dict(xk.render_flat_mxu_megakernel.routes))
    got = xk.render_flat_mxu_megakernel(scene, cam, **kw)
    assert xk.render_flat_mxu_megakernel.launches == before[0] + 1
    assert xk.render_flat_mxu_megakernel.routes == {
        r: before[1][r] + (r == route) for r in xk.ROUTES}
    want = xk.render_flat_mxu_fused(scene, cam, **kw)
    torch.cuda.synchronize()
    assert got.std() > 1e-3
    assert torch.equal(got, want)
    if staged:
        other = xk._launch_render(scene, cam, tables, "global",
                                  inclusive_uv=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(other, want)


@pytest.mark.parametrize("spp", [1, 3, 17])
def test_bvh_mxu_render_bits(cuda, spp):
    """#2b (the packed-BVH walk with superleaf leaves) equal to its plain
    version to the bit on a ragged frame, one launch a call."""
    walk = sp.attach_superleaf(_mesh(cuda))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=spp, max_depth=4, seed=2)
    before = bk.render_flat_bvh_mxu_megakernel.launches
    got = bk.render_flat_bvh_mxu_megakernel(walk, cam, **kw)
    assert bk.render_flat_bvh_mxu_megakernel.launches == before + 1
    want = bk.render_flat_bvh_fused(walk, cam, mxu_leaf=True, **kw)
    torch.cuda.synchronize()
    assert got.std() > 1e-3
    assert torch.equal(got, want)


#: #2b's scenes of ties and block sizes (tests/test_torch_superleaf_host.py)
TIE_SCENES = dict(
    twins=twin_block_scene,  # every triangle twice in one block
    # one block twice in one leaf chain, slot 0's or slot 1's first
    chain=lambda device: chain_twice_scene(device=device),
    chain_swapped=lambda device: chain_twice_scene(swap=True, device=device),
    one_lane=lambda device: one_block_scene(1, device),
    full_block=lambda device: one_block_scene(128, device))


@pytest.mark.parametrize("kind", TIE_SCENES)
def test_bvh_mxu_render_bits_on_ties(cuda, kind):
    """#2b equal to ``render_flat_bvh_fused(mxu_leaf=True)`` to the bit on
    a ragged frame at spp 3, depth 4, where every hit is a tie within a
    block (the lower lane wins) or across the two blocks of one leaf chain
    (the block visited first wins: slot 0's, block 0 or, swapped, block
    1), and on a block of one real lane and one of 128; one launch."""
    scene = TIE_SCENES[kind](cuda)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=5)
    before = bk.render_flat_bvh_mxu_megakernel.launches
    got = bk.render_flat_bvh_mxu_megakernel(scene, cam, **kw)
    assert bk.render_flat_bvh_mxu_megakernel.launches == before + 1
    want = bk.render_flat_bvh_fused(scene, cam, mxu_leaf=True, **kw)
    torch.cuda.synchronize()
    assert got.std() > 1e-3
    assert torch.equal(got, want)


def test_bvh_mxu_counting_build_matches_plain(cuda):
    """#2b's counting build (``render_bvh_with_counters(mxu_leaf=True)``):
    its image the uncounted kernel's to the bit, its totals the plain
    counting walk's (blocks visited, their real lanes, pops, pushes,
    hits), one launch."""
    walk = sp.attach_superleaf(_mesh(cuda))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=2)
    before = bk.render_bvh_with_counters.launches
    img, ctr = bk.render_bvh_with_counters(walk, cam, mxu_leaf=True, **kw)
    assert bk.render_bvh_with_counters.launches == before + 1
    ref = bk.render_flat_bvh_mxu_megakernel(walk, cam, **kw)
    plain_img, plain = bk.render_bvh_counters_fused(walk, cam, mxu_leaf=True,
                                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(img, ref) and torch.equal(img, plain_img)
    assert ctr == {k: int(v.sum()) for k, v in plain.items()}
    assert ctr["leaf_tris"] > ctr["leaf_visits"] > 0


# ---------------------------------------------------------------------------
# The peak-rate probes and the counting build of #2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", vp.MODES)
def test_peak_kernel_matches_plain(cuda, mode):
    """#9 at the JAX tile (ones) and at a random ragged size: separate
    bit-equal; contracted within 4 ulp (the plain version's float64 sum
    may round twice); the special functions within rtol 1e-6 (torch's
    library calls on the card against nvcc's)."""
    for x in (torch.ones(vp.JAX_SHAPE, device=cuda),
              torch.rand(1000, generator=torch.Generator().manual_seed(0))
              .add_(0.5).to(cuda)):
        before = vp.vpu_peak.launches
        k = vp.vpu_peak(x, mode, iters=500)
        assert vp.vpu_peak.launches == before + 1
        p = vp.peak_plain(x, mode, iters=500)
        torch.cuda.synchronize()
        assert k.shape == x.shape and torch.isfinite(k).all()
        if mode == "separate":
            assert torch.equal(k, p)
        elif mode == "contracted":
            ulp = (k.view(torch.int32) - p.view(torch.int32)).abs().max()
            assert int(ulp) <= 4
        else:
            torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dtype_kernel_matches_plain(cuda, dtype):
    """#10 at the JAX tile (0.5) and at a random size: bit-equal, one
    rounding to the type per operation on both sides."""
    for x in (torch.full((pp.ROWS, pp.COLS), 0.5, device=cuda),
              torch.rand(1002, generator=torch.Generator().manual_seed(1))
              .to(cuda)):
        before = pp.vpu_dtype.launches
        k = pp.vpu_dtype(x, dtype)
        assert pp.vpu_dtype.launches == before + 1
        p = pp.vpu_dtype_plain(x, dtype)
        torch.cuda.synchronize()
        assert k.dtype == torch.float32 and k.shape == x.shape
        assert torch.equal(k, p)
    with pytest.raises(ValueError, match="even"):
        pp.vpu_dtype(torch.ones(3, device=cuda), "bf16")


@pytest.mark.parametrize("form", ["bw", "mt"])
def test_counted_kernel_matches_uncounted_and_plain(cuda, form):
    """The counting build on the mesh scene at 128x64, spp 2, depth 4:
    its image bit-equal to the uncounted kernel's, its totals equal to the
    plain counting walk's, pops == traversals + pushes, one launch."""
    scene = _mesh(cuda, form)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=2.0, device=cuda)
    kw = dict(width=128, height=64, spp=2, max_depth=4, seed=3)
    before = bk.render_bvh_with_counters.launches
    img, ctr = bk.render_bvh_with_counters(scene, cam, **kw)
    assert bk.render_bvh_with_counters.launches == before + 1
    ref = bk.render_flat_bvh_megakernel(scene, cam, **kw)
    plain_img, plain = bk.render_bvh_counters_fused(scene, cam, **kw)
    torch.cuda.synchronize()
    assert torch.equal(img, ref)
    assert ctr == {k: int(v.sum()) for k, v in plain.items()}
    assert ctr["pops"] == ctr["traversals"] + ctr["pushes"]
    assert 0 < ctr["leaf_visits_primary"] < ctr["leaf_visits"]
    kernel, plain_np = img.cpu().numpy(), plain_img.cpu().numpy()
    np.testing.assert_allclose(kernel.mean(0), plain_np.mean(0),
                               rtol=MEAN_REL)
    assert (np.abs(kernel - plain_np) <= 1e-4).mean() >= 0.99


# ---------------------------------------------------------------------------
# The wavefront estimator: render_flat on a packed scene through kernel #3
# ---------------------------------------------------------------------------

def _packed_mesh(device):
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=2,
                                                  device=device))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=2.0,
                         device=device)
    return scene, cam


def _plain_hook_frame(scene, cam, seed, grad, **shape):
    """render_flat's frame with the hook on #3's plain version."""
    from spira_tpu_torch.render import accumulate_rows

    intersect = bk.make_sorted_tile_intersect(
        grad=grad, query=bk.intersect_packed_plain)
    acc = accumulate_rows(
        scene, cam, sp.rng.base_key(seed), width=shape["width"],
        height=shape["height"], row_start=0, n_rows=shape["height"],
        sample_offset=0, n_samples=shape["spp"],
        max_depth=shape["max_depth"], semantics="physical",
        intersect_fn=intersect)
    return mk.true_divide(acc, float(shape["spp"]))


@pytest.mark.parametrize("grad_hook", [True, False])
def test_render_flat_launches_intersect_per_bounce(cuda, grad_hook):
    """render_flat on a packed mesh on the card: spp x depth launches of
    #3 and no other kernel; the image equals the same frame with the hook
    on #3's plain version, to the bit."""
    scene, cam = _packed_mesh(cuda)
    shape = dict(width=48, height=24, spp=3, max_depth=4)
    counted = (bk.intersect_tile, bk.render_flat_bvh_megakernel,
               mk.render_flat_megakernel)
    for fn in counted:
        fn.launches = 0
    got = sp.render_flat(scene, cam, seed=2, grad_hook=grad_hook, **shape)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [3 * 4, 0, 0]
    want = _plain_hook_frame(scene, cam, 2, grad_hook, **shape)
    assert torch.equal(got, want)
    assert got.std() > 1e-3
    # against the scene's own traversal (no packed tables): the same
    # paths up to a branch flip, JAX's tolerance for its hook
    walk = sp.render_flat(dataclasses.replace(scene, packed=None), cam,
                          seed=2, **shape)
    close = torch.isclose(got, walk, rtol=1e-3, atol=1e-4).all(-1)
    assert close.float().mean() >= 0.99


def test_wavefront_frame_does_not_sync(cuda):
    scene, cam = _packed_mesh(cuda)
    shape = dict(width=32, height=16, spp=2, max_depth=4)
    for spectral in (False, True):  # builds #3, fills the constants
        sp.render_flat(scene, cam, spectral=spectral, **shape)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for spectral in (False, True):
            sp.render_flat(scene, cam, spectral=spectral, **shape)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_render_with_cpu_runs_on_the_card(cuda):
    """render_with_cpu on the sphere demo: the wavefront in reference
    semantics on the card, the same image as on the CPU up to a rare
    branch flip."""
    scene = sp.create_scene(device=cuda)
    cam = sp.default_camera(2.0, device=cuda)
    kw = dict(spp=2, max_depth=3, seed=7, semantics="reference")
    got = sp.render_flat(scene, cam, width=32, height=16, **kw)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    want = sp.render_flat(scene.to("cpu"), cam.to("cpu"), width=32,
                          height=16, **kw)
    close = torch.isclose(got.cpu(), want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.float().mean() >= 0.99
    img = sp.render_with_cpu(scene, cam, 32, 16, samples_per_pixel=2,
                             max_depth=3, seed=7)
    assert img.shape == (16, 32, 3) and img.std() > 0


# ---------------------------------------------------------------------------
# The mesh gradient: render_flat_hybrid_grad_mesh, #2 or #5 forward, #3 in
# the backward's replay
# ---------------------------------------------------------------------------

#: the backward's shape beside the plain hook (chip_smoke.py's
#: WAVEFRONT_PLAIN)
MESH_STEP = dict(width=160, height=90, spp=2, max_depth=4)


@pytest.fixture(scope="module")
def bunny():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    device = torch.device("cuda", 0)
    scene, _ = sp.create_bunny_scene(allow_download=False, device=device)
    cam = sp.bunny_camera(MESH_STEP["width"] / MESH_STEP["height"],
                          device=device)
    return scene, cam


def _mesh_fields(spectral):
    return ((("materials", "albedo_spd"),) if spectral else
            (("materials", "albedo"), ("camera", "origin"),
             ("triangles", "v0")))


@pytest.mark.parametrize("spectral", [False, True])
def test_mesh_step_launches_the_kernels_only(cuda, bunny, spectral,
                                            monkeypatch):
    """One step: the forward is one launch of #2 (#5 spectrally) whose
    image equals render_flat_engine's (the engine render() takes) to the
    bit; the backward launches #3 only, and calls neither #3's plain
    version nor the stackless walk; gradients finite, nonzero on the
    bunny's material."""
    from spira_tpu_torch.accel import traverse
    from spira_tpu_torch.bench import grad_step as gs

    scene, cam = bunny
    plain = []
    for module, name in ((bk, "intersect_packed_plain"),
                         (traverse, "_stackless_walk")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, real=real, **k: (
            plain.append(real), real(*a, **k))[1])
    counted = (bk.render_flat_bvh_megakernel,
               sb.render_flat_spectral_bvh_megakernel, bk.intersect_tile,
               mk.render_flat_megakernel)
    for fn in counted:
        fn.launches = 0
    loss, img, grads = gs.mesh_step(sp, scene, cam, seed=3, spectral=spectral,
                                    shape=MESH_STEP,
                                    fields=_mesh_fields(spectral))
    torch.cuda.synchronize()
    n3 = mesh_replay_launches(2, MESH_STEP["max_depth"])
    assert [fn.launches for fn in counted] == (
        [0, 1, n3, 0] if spectral else [1, 0, n3, 0])
    assert not plain
    want = sp.render_flat_engine(scene, cam, seed=3, spectral=spectral,
                                 **MESH_STEP)
    assert torch.equal(img, want)
    for field, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, field
    # the bunny's own material (0) takes a gradient
    assert grads[_mesh_fields(spectral)[0]][0].abs().max() > 0


@pytest.mark.parametrize("spectral", [False, True])
def test_mesh_backward_through_kernel_matches_plain_hook(cuda, bunny,
                                                         spectral):
    """The step's backward (#3 in the hook) against the same replay's
    vector-Jacobian product with the hook over #3's plain version, the
    same cotangent, to the bit: #3 gives the plain walk's bits, and the
    gathers' backward on the card (``kernels/row_gather.py``) sums each
    row in an order fixed by the number of rays, whatever the scheduler
    does."""
    from spira_tpu_torch.bench import grad_step as gs

    scene, cam = bunny
    fields = _mesh_fields(spectral)
    _, img, got = gs.mesh_step(sp, scene, cam, seed=3, spectral=spectral,
                               shape=MESH_STEP, fields=fields)
    cot = torch.full_like(img, 1.0 / img.numel())
    want = gs.mesh_replay_grads(scene, cam, cot, fields, seed=3,
                                spectral=spectral, shape=MESH_STEP,
                                query=bk.intersect_packed_plain)
    for field in fields:
        g, w = got[field], want[field]
        assert float(w.abs().max()) > 0, field
        assert torch.equal(g, w), (field, _rel_l2(g, w))


@pytest.mark.parametrize("case", ["bunny_step", "all_row0", "ragged",
                                  "spectral_spd", "one_ray", "columns_cap",
                                  "values_cap"])
def test_row_gather_kernel_against_plain(cuda, case):
    """The gathers' backward kernel (``csrc/row_gather.cu``, one launch for
    all the tables) on chip_smoke's cases (the bunny step's 230,400 rays,
    every ray on row 0, a ray count no multiple of the tile, the spectral
    SPD tables, one ray, tables at the columns' and the values' caps):
    ``index_put_(accumulate=True)``'s bits, whose order it keeps, the same
    bits over repeated launches, and against its plain version
    (``index_add_`` into zeros) each value within ``SUM_RTOL`` of the
    magnitudes summed into it."""
    import chip_smoke
    from spira_tpu_torch.kernels import row_gather as rg
    from tests.test_torch_row_gather import assert_sums_close

    idx, cots, shapes = chip_smoke.row_gather_inputs(case, cuda, seed=4)
    if case.endswith("_cap"):
        cols = sum(s[1] for s in shapes)
        assert (cols == rg.MAX_COLUMNS if case == "columns_cap"
                else shapes[0][0] * cols == rg.MAX_SLOTS)
    rg.row_gather_backward.launches = 0
    got = [rg.row_gather_backward(idx, cots, shapes) for _ in range(4)]
    assert rg.row_gather_backward.launches == 4
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got[0], g))
    for g, w, c, s in zip(got[0], rg.row_gather_plain(idx, cots, shapes),
                          cots, shapes):
        lib = torch.zeros(s, device=cuda).index_put_((idx,), c,
                                                     accumulate=True)
        assert torch.equal(g, lib), float((g - lib).abs().max())
        assert_sums_close(g, w, idx, c)


def test_row_gather_kernel_wraps_negative_indices(cuda):
    """An index counted from the end reads the row ``table[idx]`` reads,
    in the kernel's backward as in ``index_put_``'s."""
    from spira_tpu_torch.kernels import row_gather as rg

    g = torch.Generator(device=cuda).manual_seed(2)
    idx = torch.randint(-4, 4, (5_000,), generator=g, device=cuda)
    cot = torch.randn(5_000, 3, generator=g, device=cuda)
    (got,) = rg.row_gather_backward(idx, [cot], [(4, 3)])
    want = torch.zeros(4, 3, device=cuda).index_put_((idx,), cot,
                                                     accumulate=True)
    assert torch.equal(got, want)


def _cell_fields(spectral):
    """The bunny step cell's leaves (albedo and emission) and a 1-D table;
    spectrally the SPD tables."""
    return ((("materials", "albedo_spd"), ("materials", "emission_spd"))
            if spectral else (("materials", "albedo"),
                              ("materials", "emission"),
                              ("materials", "roughness")))


@pytest.mark.parametrize("spectral", [False, True])
def test_mesh_backward_gathers_against_index_put(cuda, bunny, spectral,
                                                 monkeypatch):
    """The mesh step's backward with its material gathers through the
    kernel against the same backward through ``table[idx]``'s own
    (``index_put_`` with accumulate; the kernel's cap set to 0): the same
    image and the same gradients to the bit (the kernel keeps
    ``index_put_``'s order; the 1-D roughness keeps ``table[idx]``); the
    kernel launched ``grad_spp x max_depth`` times, and none on the other
    route."""
    from spira_tpu_torch.bench import grad_step as gs
    from spira_tpu_torch.kernels import row_gather as rg

    scene, cam = bunny
    fields = _cell_fields(spectral)
    rg.row_gather_backward.launches = 0
    _, img, got = gs.mesh_step(sp, scene, cam, seed=3, spectral=spectral,
                               shape=MESH_STEP, fields=fields)
    torch.cuda.synchronize()
    assert rg.row_gather_backward.launches == (
        gs.MESH_GRAD_SPP * MESH_STEP["max_depth"])
    monkeypatch.setattr(rg, "MAX_SLOTS", 0)
    rg.row_gather_backward.launches = 0
    _, img0, want = gs.mesh_step(sp, scene, cam, seed=3, spectral=spectral,
                                 shape=MESH_STEP, fields=fields)
    torch.cuda.synchronize()
    assert rg.row_gather_backward.launches == 0
    assert torch.equal(img, img0)
    for field in fields:
        g, w = got[field], want[field]
        if field[1] in ("albedo", "emission", "albedo_spd"):
            assert float(w.abs().max()) > 0, field
        assert torch.equal(g, w), (field, _rel_l2(g, w))


def test_row_gather_launches_a_step_and_none_a_frame(cuda, bunny):
    """The bunny step's gathers' backward: one launch a bounce of each
    replayed sample (``grad_spp x max_depth``) for the cell's albedo and
    emission together; a ``render()`` frame and a value-only replay
    launch none."""
    from spira_tpu_torch.bench import grad_step as gs
    from spira_tpu_torch.kernels import row_gather as rg
    from spira_tpu_torch.render import mesh_replay

    scene, cam = bunny
    rg.row_gather_backward.launches = 0
    sp.render(scene, cam, MESH_STEP["width"], MESH_STEP["height"],
              samples_per_pixel=2, max_depth=4, seed=3)
    sp.render(scene, cam, MESH_STEP["width"], MESH_STEP["height"],
              samples_per_pixel=2, max_depth=4, seed=3, engine="wavefront")
    with torch.no_grad():
        mesh_replay(scene, cam, width=64, height=32, grad_spp=2,
                    max_depth=4, seed=3)
    torch.cuda.synchronize()
    assert rg.row_gather_backward.launches == 0
    gs.mesh_step(sp, scene, cam, seed=3, shape=MESH_STEP,
                 fields=_cell_fields(False)[:2])
    torch.cuda.synchronize()
    assert rg.row_gather_backward.launches == (
        gs.MESH_GRAD_SPP * MESH_STEP["max_depth"])


def test_mesh_step_does_not_sync(cuda, bunny):
    """A step with the packet backward enqueues its work and returns."""
    from spira_tpu_torch.bench import grad_step as gs

    scene, cam = bunny
    kw = dict(seed=1, shape=dict(MESH_STEP, width=64, height=32),
              fields=_mesh_fields(False))
    gs.mesh_step(sp, scene, cam, **kw)  # builds, fills the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gs.mesh_step(sp, scene, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_bvh_frame_records_put_down_to_their_spans(cuda, bunny):
    """A profiled bunny frame through ``render()``: kernel #2's record is
    put down to ``spira.kernel.render_flat_bvh_megakernel`` through its
    launch record (``bench/spans.py``), the tone map's to
    ``spira.image.tonemap``, the copy to the host to
    ``spira.image.to_host``, and every record of the frame to a span."""
    from torch.profiler import ProfilerActivity

    from spira_tpu_torch.bench import spans
    from spira_tpu_torch.bench.timing import profile_window

    scene, cam = bunny
    args = (scene, cam, MESH_STEP["width"], MESH_STEP["height"])
    kw = dict(samples_per_pixel=4, max_depth=4, seed=3)
    sp.render(*args, **kw)  # builds, fills the constants
    torch.cuda.synchronize()
    with profile_window([ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
        sp.render(*args, **kw)
        torch.cuda.synchronize()
    put = [(n, s) for n, _, _, s in spans.reduce(prof).device]
    walk = {s for n, s in put if "bvh_megakernel" in n}
    assert walk == {"spira.kernel.render_flat_bvh_megakernel"}, put
    assert {s for n, s in put if "DtoH" in n} == {"spira.image.to_host"}
    assert "spira.image.tonemap" in {s for _, s in put}
    assert all(s is not None for _, s in put), put


def test_bvh_sorted_is_render_flat_without_grad_hook(cuda):
    scene, cam = _packed_mesh(cuda)
    shape = dict(width=48, height=24, spp=2, max_depth=3, seed=4)
    bk.intersect_tile.launches = 0
    for spectral in (False, True):
        got = sp.render_flat_engine(scene, cam, engine="bvh_sorted",
                                    spectral=spectral, **shape)
        want = sp.render_flat(scene, cam, grad_hook=False, spectral=spectral,
                              **shape)
        assert torch.equal(got, want) and got.std() > 1e-3
    assert bk.intersect_tile.launches == 2 * 2 * 2 * 3


# ---------------------------------------------------------------------------
# The command line and its renderers: cli render, the adaptive, progressive
# and preview renderers, the inverse step
# ---------------------------------------------------------------------------

#: the CLI's shape here (the block-set adaptive renderer needs W % 128 == 0)
CLI = dict(width=128, height=64, spp=4, max_depth=3)
CLI_ARGS = ["--width", "128", "--height", "64", "--spp", "4", "--max-depth",
            "3", "--no-progress"]


def _counted_launches(fn):
    """(fn(), the launches of each path-tracing and nearest-hit kernel in
    it)."""
    counted = dict(megakernel=mk.render_flat_megakernel,
                   bvh_megakernel=bk.render_flat_bvh_megakernel,
                   spectral_megakernel=sf.render_flat_spectral_megakernel,
                   spectral_bvh_megakernel=(
                       sb.render_flat_spectral_bvh_megakernel),
                   bvh_intersect=bk.intersect_tile)
    for f in counted.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counted.items()}


@pytest.mark.parametrize("scene,spectral,kernel", [
    ("default", False, "megakernel"), ("bunny", False, "bvh_megakernel"),
    ("cornell", True, "spectral_megakernel"),
    ("bunny", True, "spectral_bvh_megakernel")])
def test_cli_render_launches_its_kernel(cuda, tmp_path, scene, spectral,
                                        kernel):
    """``cli render`` launches exactly its scene's kernel once, and its
    PNG is ``render_hdr``'s image tone mapped, to the bit."""
    from PIL import Image

    from spira_tpu_torch import cli
    from spira_tpu_torch.io import image as img_io
    from spira_tpu_torch.utils import config

    out = str(tmp_path / "cli.png")
    argv = ["render", "--scene", scene, *CLI_ARGS, "--seed", "2", "-o", out]
    rc, got = _counted_launches(
        lambda: cli.main(argv + ["--spectral"] * spectral))
    want = dict.fromkeys(got, 0)
    want[kernel] = 1
    assert rc == 0 and got == want
    s, c = config.build_scene(config.RenderConfig(scene=scene, **CLI))
    hdr = sp.render_hdr(s, c, CLI["width"], CLI["height"], spp=CLI["spp"],
                        max_depth=CLI["max_depth"], seed=2,
                        spectral=spectral)
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  img_io.to_uint8(img_io.tonemap_gamma(hdr)))


def _cli_bunny():
    """The bunny and its camera at ``CLI``'s shape, as ``cli render``
    builds them."""
    from spira_tpu_torch.utils import config

    return config.build_scene(config.RenderConfig(scene="bunny", **CLI))


def test_adaptive_bunny_launches_intersect_and_is_deterministic(cuda):
    """The adaptive renderer on the packed bunny: every bounce's nearest
    hit from #3 and no other kernel, one host sync a round (counted by the
    sync debug mode; the meter is off), the same image twice."""
    from spira_tpu_torch import pipeline
    from spira_tpu_torch.utils import config

    scene, cam = _cli_bunny()
    cfg = config.RenderConfig(scene="bunny", progress=False,
                              **dict(CLI, spp=8))
    kw = dict(tol=0.05, min_spp=2, chunk=2, granularity="block",
              return_stats=True)
    (a, stats), got = _counted_launches(
        lambda: pipeline.render_adaptive(scene, cam, cfg, **kw))
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            b, _ = pipeline.render_adaptive(scene, cam, cfg, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert got["bvh_intersect"] > 0
    assert sum(got.values()) == got["bvh_intersect"]
    assert stats["host_syncs"] == stats["rounds"] == len(syncs) >= 2
    assert np.isfinite(a).all() and a.std() > 1e-3
    np.testing.assert_array_equal(a, b)


def test_progressive_resume_is_exact_on_the_card(cuda, tmp_path,
                                                 monkeypatch):
    """The sphere demo in chunks of 2: the third chunk raises, the
    checkpoint holds 4 samples, and the resume equals the uninterrupted
    render and the one-shot wavefront render, to the bit."""
    from spira_tpu_torch import pipeline
    from spira_tpu_torch.utils import checkpoint as ckpt
    from spira_tpu_torch.utils import config

    ckdir = str(tmp_path / "ck")
    cfg = config.RenderConfig(progress=False, checkpoint_dir=ckdir,
                              checkpoint_every=2, **dict(CLI, spp=8))
    scene, cam = config.build_scene(cfg)
    chunk = pipeline._render_chunk
    calls = []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise InterruptedError("preempted")
        return chunk(*args, **kw)

    monkeypatch.setattr(pipeline, "_render_chunk", flaky)
    with pytest.raises(InterruptedError):
        pipeline.render_progressive(scene, cam, cfg)
    assert ckpt.load_render_state(ckdir)[1] == 4
    monkeypatch.setattr(pipeline, "_render_chunk", chunk)
    resumed = pipeline.render_progressive(scene, cam, cfg)
    whole = pipeline.render_progressive(
        scene, cam, dataclasses.replace(cfg, checkpoint_dir=None))
    np.testing.assert_array_equal(resumed, whole)
    one_shot = sp.render_hdr(scene, cam, CLI["width"], CLI["height"], spp=8,
                             max_depth=CLI["max_depth"], engine="wavefront")
    np.testing.assert_array_equal(resumed, one_shot.cpu().numpy())


@pytest.mark.parametrize("shading", ["preview", "normal"])
def test_preview_launches_intersect_once(cuda, shading):
    """The preview on the packed bunny: one #3 launch, the image equal to
    the preview through #3's plain version to the bit (both recompute the
    winning hit with the same operations)."""
    from spira_tpu_torch.integrator.preview import render_flat_preview

    scene, cam = _cli_bunny()
    kw = dict(width=CLI["width"], height=CLI["height"], seed=1,
              shading=shading)
    got, n = _counted_launches(lambda: render_flat_preview(scene, cam, **kw))
    assert n["bvh_intersect"] == 1 and sum(n.values()) == 1
    plain = render_flat_preview(
        scene, cam, intersect_fn=bk.make_sorted_tile_intersect(
            query=bk.intersect_packed_plain), **kw)
    assert torch.equal(got, plain) and got.std() > 1e-3


def test_inverse_step_on_the_bunny(cuda, monkeypatch):
    """An inverse step on the packed bunny (``intersect="packet"``):
    #3 in its slot form (``with_slot``, the ``grad=True`` hook) and no
    other kernel, no host sync (the loss is read outside the step), the
    albedo moved, the loss finite."""
    from spira_tpu_torch.diff.inverse import make_inverse_step

    scene, cam = _cli_bunny()
    shape = dict(width=64, height=32, spp=1, max_depth=2)
    step, init = make_inverse_step(intersect="packet", **shape)
    target = sp.render_flat(scene, cam, seed=9, **shape)
    params = {"albedo": torch.full_like(scene.materials.albedo, 0.5)}
    opt = init(params)
    params, opt, loss = step(params, opt, scene, cam, target, 0)  # warm-up
    torch.cuda.synchronize()
    before = params["albedo"].clone()
    with_slot = []
    real = bk.intersect_tile

    def spy(*a, **k):  # the kernel's wrapper counts on this name
        with_slot.append(k.get("with_slot", False))
        return real(*a, **k)

    monkeypatch.setattr(bk, "intersect_tile", spy)
    (params, opt, loss), got = _counted_launches(lambda: _no_sync(
        lambda: step(params, opt, scene, cam, target, 1)))
    assert got["bvh_intersect"] > 0
    assert sum(got.values()) == got["bvh_intersect"]
    assert len(with_slot) == got["bvh_intersect"] and all(with_slot)
    assert torch.isfinite(loss)
    assert not torch.equal(params["albedo"], before)


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Kernel #2's row and sample offsets (the sharded renderer's shard body)
# ---------------------------------------------------------------------------

#: #2 over row leaves in each form, and #2b over superleaf blocks
SHARD_TREES = ("bw", "mt", "superleaf")


def _shard_scene(device, tree):
    if tree == "superleaf":
        return sp.attach_superleaf(_mesh(device))
    return _mesh(device, tree)


@pytest.mark.parametrize("tree", SHARD_TREES)
def test_bvh_rows_bit_equal_to_plain_at_offsets(cuda, tree):
    """``bvh_rows`` on rows 7-15 of a 37x23 frame at samples 5-7, depth
    4: one launch of #2 (#2b on superleaf blocks), each pixel's sum equal
    to the plain version's over the same rows and samples to the bit."""
    scene = _shard_scene(cuda, tree)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    mxu = tree == "superleaf"
    counter = (bk.render_flat_bvh_mxu_megakernel if mxu
               else bk.render_flat_bvh_megakernel)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=9)
    before = counter.launches
    got = bk.bvh_rows(scene, cam, n_rows=9, row_start=7, sample_offset=5,
                      mxu_leaf=mxu, **kw)
    assert counter.launches == before + 1
    want = bk.render_flat_bvh_fused(scene, cam, mxu_leaf=mxu,
                                    rows=(9, 7, 5), normalize=False, **kw)
    torch.cuda.synchronize()
    assert got.shape == (9 * 37, 3) and got.std() > 1e-3
    assert torch.equal(got, want)


@pytest.mark.parametrize("tree", SHARD_TREES)
def test_tile_split_equals_the_frame(cuda, tree):
    """A 4x1 split of a 64x48 frame at spp 4 (a power of two), each tile
    one ``bvh_rows`` launch, the tiles' sums over spp: the unsharded #2
    (#2b) frame to the bit; a split of the samples within float-sum order
    (the same samples added in another order: at most 2 (spp - 1) units
    of 2^-24 of each channel, whose terms are not negative)."""
    scene = _shard_scene(cuda, tree)
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=64 / 48, device=cuda)
    mxu = tree == "superleaf"
    kw = dict(width=64, height=48, max_depth=4, seed=2, mxu_leaf=mxu)
    frame = bk.render_flat_bvh_megakernel(scene, cam, spp=4, **kw)
    tiles = [bk.bvh_rows(scene, cam, n_rows=12, row_start=12 * t,
                         sample_offset=0, spp=4, **kw) for t in range(4)]
    assert torch.equal(mk.true_divide(torch.cat(tiles), 4.0), frame)
    halves = [bk.bvh_rows(scene, cam, n_rows=48, row_start=0,
                          sample_offset=2 * k, spp=2, **kw)
              for k in range(2)]
    split = mk.true_divide(halves[0] + halves[1], 4.0)
    assert float(((split - frame).abs() - 6 * 2.0 ** -24 * frame).max()) \
        <= 0.0


@pytest.mark.parametrize("kernel", ["#2", "#4", "#5", "#7"])
def test_offsets_zero_keep_the_frames(cuda, kernel):
    """The kernels that share ``render_mesh`` or ``render_samples`` and
    pass it offsets 0 (#2's whole frame, #4, #5 and #7) on a ragged 37x23
    frame at spp 3: equal to their plain versions to the bit, so the
    offsets changed none of their pixels."""
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=37 / 23, device=cuda)
    kw = dict(width=37, height=23, spp=3, max_depth=4, seed=5)
    rows, stream, _ = _superleaf_scenes(cuda)
    pair = {
        "#2": (bk.render_flat_bvh_megakernel, bk.render_flat_bvh_fused,
               rows),
        "#4": (sf.render_flat_spectral_megakernel,
               sf.render_flat_fused_spectral,
               sp.create_cornell_box(device=cuda)),
        "#5": (sb.render_flat_spectral_bvh_megakernel,
               sb.render_flat_spectral_bvh_fused, rows),
        "#7": (xk.render_flat_mxu_megakernel, xk.render_flat_mxu_fused,
               stream),
    }
    kernel_fn, plain_fn, scene = pair[kernel]
    got = kernel_fn(scene, cam, **kw)
    want = plain_fn(scene, cam, **kw)
    torch.cuda.synchronize()
    assert got.std() > 1e-3
    assert torch.equal(got, want)
