"""The CUDA kernels against the port's plain versions, on the card: the
sphere megakernel, the packed-BVH path tracer and the packed-BVH
nearest-hit query.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; run it there without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch.accel import pairs
from spira_tpu_torch.kernels import bvh_megakernel as bk
from spira_tpu_torch.kernels import megakernel as mk

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
        mk.render_flat_megakernel(scene, sp.default_camera(2.0), width=16,
                                  height=8)
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
    scene = sp.create_mesh_scene(subdivisions=subdivisions)
    return sp.attach_packed(scene, form=form).to(device)


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
    with pytest.raises(NotImplementedError, match="item 18"):
        bk.render_flat_bvh_megakernel(scene, cam, mxu_leaf=True, **kw)
    cpu_tables = dataclasses.replace(scene, packed=scene.packed.to("cpu"))
    with pytest.raises(ValueError, match="packed pairs is on cpu"):
        bk.render_flat_bvh_megakernel(cpu_tables, cam, **kw)
    with pytest.raises(ValueError, match="camera table is on cpu"):
        bk.render_flat_bvh_megakernel(
            scene, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0)), **kw)
    o, d = _rays(256, cuda)
    with pytest.raises(ValueError, match="packed pairs is on cpu"):
        bk.intersect_tile(cpu_tables.packed, o, d)
    with pytest.raises(ValueError, match="dirs is on cpu"):
        bk.intersect_tile(scene.packed, o, d.cpu())
    with pytest.raises(ValueError, match="traversal stack"):
        bk.intersect_tile(deep.packed, o, d)
