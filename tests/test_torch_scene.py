"""The port's scene model, camera and packed tables against the JAX
package: value-exact, except the camera fields derived through tan()."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.kernels import megakernel as jmk
from spira_tpu_torch.kernels import megakernel as tmk

torch.set_num_threads(1)

#: tan/deg2rad may differ by an ULP between XLA and PyTorch.
TRIG_ATOL = 1e-6
TRIG_FIELDS = ("lower_left_corner", "horizontal", "vertical")
#: camera builders of either package (``kw``: the port's device)
CAMERAS = {
    "default": (
        lambda m, **kw: m.default_camera(640 / 360, **kw),
    ),
    "thin_lens": (
        lambda m, **kw: m.make_camera((0.5, 1.0, 3.0), (0.0, 0.2, 0.0),
                                      vfov=45.0, aspect_ratio=2.0,
                                      aperture=0.3, focus_dist=2.5, **kw),
    ),
    "cornell": (lambda m, **kw: m.cornell_camera(1.0, **kw),),
}
SCENES = ("create_scene", "create_cornell_box")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_fields_equal(port, ref, fields):
    for f in fields:
        got, want = _np(getattr(port, f)), _np(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("scene_fn", SCENES)
def test_scene_tables_value_exact(scene_fn):
    ref = getattr(st, scene_fn)()
    port = getattr(sp, scene_fn)(device="cpu")
    _assert_fields_equal(port.spheres, ref.spheres,
                         ("centers", "radii", "material"))
    _assert_fields_equal(port.triangles, ref.triangles,
                         ("v0", "e1", "e2", "normal", "material"))
    _assert_fields_equal(
        port.materials, ref.materials,
        ("albedo", "emission", "metallic", "roughness", "ior",
         "transmission", "cauchy_b", "albedo_spd", "emission_spd"),
    )


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_matches(name):
    (build,) = CAMERAS[name]
    ref, port = build(st), build(sp, device="cpu")
    assert port.has_lens == ref.has_lens == (name == "thin_lens")
    _assert_fields_equal(port, ref, ("origin", "u", "v", "lens_radius"))
    for f in TRIG_FIELDS:
        np.testing.assert_allclose(
            _np(getattr(port, f)), _np(getattr(ref, f)), rtol=0,
            atol=TRIG_ATOL, err_msg=f,
        )


@pytest.mark.parametrize("scene_fn", SCENES)
def test_converter_equals_port_scene(scene_fn):
    """scene_from_numpy of the JAX scene is the port's own scene, field by
    field, and packs to the JAX packers' tables exactly."""
    ref = getattr(st, scene_fn)()
    conv = sp.scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                               device="cpu")
    own = getattr(sp, scene_fn)(device="cpu")
    for part, fields in (
        ("spheres", ("centers", "radii", "material")),
        ("triangles", ("v0", "e1", "e2", "normal", "material")),
        ("materials", ("albedo", "emission", "metallic", "roughness", "ior",
                       "transmission", "cauchy_b", "albedo_spd",
                       "emission_spd")),
    ):
        _assert_fields_equal(getattr(conv, part), getattr(own, part), fields)
    for port in (conv, own):
        np.testing.assert_array_equal(
            tmk.pack_scene(port).numpy(), np.asarray(jmk.pack_scene_jnp(ref))
        )
        np.testing.assert_array_equal(
            tmk.pack_triangles(port).numpy(),
            np.asarray(jmk.pack_triangles_jnp(ref)),
        )


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_converter_and_pack(name):
    (build,) = CAMERAS[name]
    ref = build(st)
    conv = sp.camera_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                device="cpu")
    assert conv.has_lens == ref.has_lens
    want = np.asarray(jmk.pack_camera_jnp(ref))
    np.testing.assert_array_equal(tmk.pack_camera(conv).numpy(), want)
    # the port's own camera packs the same record, trig fields within 1e-6
    own = build(sp, device="cpu")
    np.testing.assert_allclose(tmk.pack_camera(own).numpy(), want,
                               rtol=0, atol=TRIG_ATOL)
    n = 19 if ref.has_lens else 12
    got = tmk.cam_tuple(tmk.pack_camera(conv), conv.has_lens)
    assert len(got) == n
    np.testing.assert_array_equal(
        np.array([float(x) for x in got], np.float32), want[0, :n]
    )


def test_dataclass_to_and_replace():
    scene = sp.create_scene(device="cpu")
    moved = scene.to("cpu")
    assert moved.device == torch.device("cpu")
    np.testing.assert_array_equal(moved.spheres.centers.numpy(),
                                  scene.spheres.centers.numpy())
    with pytest.raises(dataclasses.FrozenInstanceError):
        scene.bvh = 1
    assert sp.core.types.replace(scene, bvh=1).bvh == 1
    cam = sp.default_camera(2.0, device="cpu").to("cpu")
    assert cam.has_lens is False


def test_converter_refuses_bvh_scenes():
    """The converter carries ``bvh``, ``packed`` (tests/test_torch_bvh.py)
    and the three ``wide`` packings (tests/test_torch_mxu.py); it refuses
    a ``wide`` table that is none of them."""
    scene = sp.create_scene(device="cpu")
    fields = {f.name: getattr(scene, f.name)
              for f in dataclasses.fields(scene) if f.name != "wide"}
    with pytest.raises(ValueError, match="WideBVH, MXUBVH or SuperleafBVH"):
        sp.scene_from_numpy(types.SimpleNamespace(**fields, wide=object()),
                            device="cpu")


@pytest.mark.parametrize("build", [
    lambda: sp.create_scene(),
    lambda: sp.default_camera(2.0),
    lambda: sp.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
    lambda: sp.create_mesh_scene(subdivisions=0),
])
def test_constructors_default_to_the_card(build):
    """With no device named, the constructors build on CUDA; on a host
    without it they raise rather than quietly build on the CPU."""
    if torch.cuda.is_available():
        made = build()
        tensor = getattr(made, "origin", None)
        if tensor is None:
            tensor = getattr(made, "albedo", None)
        if tensor is None:
            tensor = made.materials.albedo
        assert tensor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
