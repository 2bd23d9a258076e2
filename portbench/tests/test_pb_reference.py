"""The reference against the frozen pieces it copies and against the
port's plain versions, at tiny sizes on the CPU: the same draws, the same
nearest hits, the same pixels and gradients."""

import json

import numpy as np
import pytest
import torch

from pbcore import cells
from pbref import bvh, judge, mesh, pcg, scene as rscene, threefry, tracer
from pbref import wavefront

W, H = 20, 12


def _config(name):
    cfg = cells.load_json(cells.HERE / "configs" / f"{name}.json")
    return cfg, mesh.make_parts(cfg["mesh"])


def _port(name, cfg, parts):
    cell_builder = cells.load_module(cells.HERE / "configs" / f"{name}.py",
                                     "portbench_config_" + name)
    return cell_builder.build(cfg, parts, "cpu", W / H)


def test_draws_are_the_ports():
    from spira_tpu_torch.core import pcg as ppcg, rng as prng

    pix = torch.arange(5000)
    for a, b in zip(pcg.uniform4(pix, 3, 17, 2**31 + 5),
                    ppcg.uniform4(pix, 3, 17, 2**31 + 5)):
        assert torch.equal(a, b)
    key = threefry.fold_in(threefry.sample_key(threefry.base_key(99), 4), 0)
    pkey = prng.fold_in(prng.sample_key(prng.base_key(99), 4), 0)
    assert key == pkey
    assert torch.equal(threefry.uniform(key, (300, 2), "cpu"),
                       prng.uniform(pkey, (300, 2), "cpu"))
    assert torch.equal(threefry.normal(key, (300, 3), "cpu"),
                       prng.normal(pkey, (300, 3), "cpu"))


@pytest.mark.parametrize("tail", [0, bvh.TAIL])
def test_tree_finds_the_brute_force_hit(monkeypatch, tail):
    """The walk, and the walk that hands its last rays to brute force."""
    monkeypatch.setattr(bvh, "TAIL", tail)
    verts, faces = mesh.part(2, (0.5, 0.4, 0.6), (10, 20, 0), (0, 0.3, 0))
    tri = mesh.triangle_arrays([(verts, faces)], 0)
    t = {k: torch.as_tensor(tri[k]) for k in ("v0", "e1", "e2", "normal")}
    tree = bvh.build(t)
    g = torch.Generator().manual_seed(0)
    o = torch.rand(2000, 3, generator=g) * 4 - 2
    d = torch.nn.functional.normalize(torch.randn(2000, 3, generator=g),
                                      dim=-1)
    d[:1000] = torch.nn.functional.normalize(-o[:1000] + 0.05 * d[:1000],
                                             dim=-1)
    best = torch.full((2000,), 1e20)
    tt, prim = bvh.nearest(tree, o, d, best)
    # brute force: every triangle
    leaves = torch.arange(tree.order.numel() // bvh.LEAF)
    n = leaves.numel()
    bt = torch.full((2000,), 1e20)
    bp = torch.full((2000,), -1, dtype=torch.long)
    for k in range(n):
        won, tw, pw = bvh._leaf(tree, torch.full((2000,), k), o, d, bt)
        bt = torch.where(won, tw, bt)
        bp = torch.where(won, pw, bp)
    assert (prim >= 0).sum() > 800
    assert torch.equal(tt, bt)
    assert torch.equal(prim, bp)


@pytest.mark.parametrize("name", ["demo", "bunny"])
def test_pixels_are_the_plain_versions(name):
    from spira_tpu_torch.render import render_flat_engine

    cfg, parts = _config(name)
    scene, cam = _port(name, cfg, parts)
    engine = "cuda_bvh" if name == "bunny" else "cuda"
    seed = 2**33 + 11
    img = render_flat_engine(scene, cam, width=W, height=H, spp=3,
                             max_depth=5, seed=seed, engine=engine)
    rs = judge.scene_for(cfg, parts, "cpu")
    rc = rscene.make_camera(cfg["camera"], W / H, "cpu")
    ref = tracer.render_pixels(rs, rc, torch.arange(W * H), width=W,
                               height=H, spp=3, max_depth=5, seeds=[seed])
    assert torch.equal(img, ref[0])
    # a subset of pixels stands alone, and neither the batching of
    # samples nor another frame beside it moves a sum
    sub = torch.tensor([0, 7, 100, W * H - 1])
    part = tracer.render_pixels(rs, rc, sub, width=W, height=H, spp=3,
                                max_depth=5, seeds=[5, seed], lanes=9)
    assert torch.equal(part[1], ref[0][sub])


def test_replay_and_its_gradient_are_the_ports():
    from spira_tpu_torch.render import mesh_replay, with_fields

    cfg, parts = _config("bunny")
    scene, cam = _port("bunny", cfg, parts)
    albedo = torch.full_like(scene.materials.albedo, 0.5).requires_grad_()
    emission = torch.full_like(scene.materials.emission,
                               1.0).requires_grad_()
    sc, cm = with_fields(scene, cam, {("materials", "albedo"): albedo,
                                      ("materials", "emission"): emission})
    out = mesh_replay(sc, cm, width=W, height=H, grad_spp=2, max_depth=4,
                      seed=77, bwd="packet")
    cot = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    ga, ge = torch.autograd.grad(out, [albedo, emission], cot)
    rs = judge.scene_for(cfg, parts, "cpu")
    rc = rscene.make_camera(cfg["camera"], W / H, "cpu")
    ra = torch.full_like(rs.materials["albedo"], 0.5).requires_grad_()
    re = torch.full_like(rs.materials["emission"], 1.0).requires_grad_()
    ref = wavefront.replay_mean(rs.with_materials(albedo=ra, emission=re),
                                rc, width=W, height=H, spp=2, max_depth=4,
                                seed=77)
    assert torch.allclose(out, ref, rtol=0, atol=1e-6)
    ra_g, re_g = torch.autograd.grad(ref, [ra, re], cot)
    assert torch.allclose(ga, ra_g, rtol=1e-5, atol=1e-7)
    assert torch.allclose(ge, re_g, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("tonemap", ["gamma", "aces", "none"])
def test_tone_map_is_the_ports(tonemap):
    """Each tone map that ``render()`` offers, found by its name."""
    from spira_tpu_torch.io import image

    assert tonemap in image.TONEMAPS
    hdr = torch.linspace(-0.5, 3.5, 3000).reshape(1000, 3)
    assert np.array_equal(judge.tonemap_uint8(hdr, tonemap),
                          image.to_uint8(image.TONEMAPS[tonemap](hdr)))


def test_every_tone_map_of_the_port_has_a_reference():
    from spira_tpu_torch.io import image

    from pbref import plugin

    for name in image.TONEMAPS:
        assert callable(plugin("tonemaps", name).apply)


def test_configs_hold_the_ports_scenes():
    """The configuration files state the scenes of the port's own
    ``create_scene`` and ``create_bunny_scene``."""
    from spira_tpu_torch.scene.bunny import create_bunny_scene
    from spira_tpu_torch.scene.scene import create_scene

    for name, port in (("demo", create_scene(device="cpu")),
                       ("bunny", create_bunny_scene(
                           allow_download=False, device="cpu")[0])):
        cfg, parts = _config(name)
        rs = judge.scene_for(cfg, parts, "cpu")
        assert torch.equal(rs.centers, port.spheres.centers)
        assert torch.equal(rs.radii, port.spheres.radii)
        for k in ("albedo", "emission", "metallic", "roughness"):
            assert torch.equal(rs.materials[k], getattr(port.materials, k))
        if parts:
            assert rs.tris["v0"].shape == port.triangles.v0.shape
            assert json.dumps(sorted(map(tuple, rs.tris["v0"].tolist()))) \
                == json.dumps(sorted(map(tuple,
                                         port.triangles.v0.tolist())))
