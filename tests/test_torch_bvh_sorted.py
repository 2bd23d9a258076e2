"""``render_flat_bvh_sorted`` and the engine ``bvh_sorted`` on the CPU: the
counterpart of JAX's ``tests/test_bvh_sorted.py:18``.

The port does not sort (a per-ray walk's hit does not depend on the
rays' order), so where JAX holds its sorted and unsorted images equal to
the bit, the port holds its image equal to the bit to the wavefront
frame with the packed-BVH hook in its forward form (which is
``render_flat(..., grad_hook=False)`` on the card, where ``render_flat``
takes the hook); and, as JAX does, within rtol 1e-3 / atol 1e-4 of the
wavefront over the scene's own stackless walk, on the subdivision-1
mesh at 128x16, spp 2, depth 3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch.kernels import bvh_megakernel as tbk
from spira_tpu_torch.kernels.megakernel import true_divide
from spira_tpu_torch.render import accumulate_rows

torch.set_num_threads(1)

KW = dict(width=128, height=16, spp=2, max_depth=3, seed=5)


@pytest.fixture(scope="module")
def mesh():
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=4.0,
                         device="cpu")
    return scene, cam


def _hook_frame(scene, cam, spectral=False):
    acc = accumulate_rows(
        scene, cam, sp.rng.base_key(KW["seed"]), width=KW["width"],
        height=KW["height"], row_start=0, n_rows=KW["height"],
        sample_offset=0, n_samples=KW["spp"], max_depth=KW["max_depth"],
        semantics="physical", spectral=spectral,
        intersect_fn=tbk.make_sorted_tile_intersect(grad=False))
    return true_divide(acc, float(KW["spp"]))


def test_bvh_sorted_matches_the_hook_frame_and_the_walk(mesh):
    scene, cam = mesh
    got = sp.render_flat_bvh_sorted(scene, cam, **KW)
    assert torch.isfinite(got).all() and got.std() > 1e-3
    assert torch.equal(got, _hook_frame(scene, cam))
    walk = sp.render_flat(scene, cam, **KW)
    np.testing.assert_allclose(got.numpy(), walk.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_engine_dispatch(mesh):
    """render_flat_engine(engine="bvh_sorted") is render_flat_bvh_sorted,
    RGB and spectral (JAX's tests/test_bvh_sorted.py passes spectral
    through the same way), and render() takes it by name."""
    scene, cam = mesh
    small = dict(KW, width=32, height=8)
    assert sp.select_engine(scene, "physical", False, "bvh_sorted") == \
        "bvh_sorted"
    for spectral in (False, True):
        got = sp.render_flat_engine(scene, cam, engine="bvh_sorted",
                                    spectral=spectral, **small)
        want = sp.render_flat_bvh_sorted(scene, cam, spectral=spectral,
                                         **small)
        assert torch.equal(got, want)
    img = sp.render(scene, cam, 32, 8, samples_per_pixel=1, max_depth=2,
                    engine="bvh_sorted")
    assert img.shape == (8, 32, 3) and img.std() > 0


def test_bvh_sorted_refusals(mesh):
    scene, cam = mesh
    small = dict(width=8, height=4, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="physical semantics"):
        sp.render_flat_engine(scene, cam, engine="bvh_sorted",
                              semantics="reference", **small)
    with pytest.raises(ValueError, match="scene.packed"):
        sp.render_flat_bvh_sorted(dataclasses.replace(scene, packed=None),
                                  cam, **small)
    with pytest.raises(ValueError, match="spp"):
        sp.render_flat_bvh_sorted(scene, cam, **dict(small, spp=0))
    # JAX's interpret form is a TPU knob, not an engine of the port
    with pytest.raises(NotImplementedError, match="bvh_sorted_interpret"):
        sp.select_engine(scene, "physical", False, "bvh_sorted_interpret")
