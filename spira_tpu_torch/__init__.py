"""spira_tpu_torch — the PyTorch/CUDA port of spira_tpu.

The JAX package ``spira_tpu`` is the reference; this package grows beside it
slice by slice (see ROADMAP.md).  It has the forward render, RGB and
spectral (hero wavelengths, Chebyshev SPDs, dispersion), of sphere and
small-triangle scenes and of mesh scenes through a packed BVH: the scene
model and colorimetry, the BVH builders and packers, the plain PyTorch
tracers, and hand-written CUDA kernels for Hopper (``csrc/megakernel.cu``,
``csrc/bvh_megakernel.cu``, ``csrc/spectral_megakernel.cu``), behind the
same ``render`` entry point; the superleaf engines of
:mod:`spira_tpu_torch.experiments` (``csrc/mxu_megakernel.cu`` and the
block leaves of ``csrc/superleaf.cuh``); and the differentiable step of
sphere and small-triangle scenes (``render_flat_hybrid_grad``,
``render_mse_loss_and_grads``), whose gradients come from a hand-written
adjoint kernel (``csrc/grad_megakernel.cu``); and the wavefront estimator
(``render_flat``, engine ``wavefront``, ``render_with_cpu``), whose
threefry draws are JAX's own bits and whose nearest hits on a packed
scene on the card come from the packed-BVH query kernel.  Scenes and
cameras are made on the card unless ``device="cpu"`` is asked for.
Nothing here imports JAX.
"""

from .accel.bvh import build_two_level
from .accel.mxu import attach_mxu, attach_superleaf
from .accel.pairs import attach_packed
from .accel.wide import attach_wide
from .core import colorimetry, pcg, rng, vecmath
from .core.convert import camera_from_numpy, scene_from_numpy
from .kernels.grad_megakernel import render_mse_loss_and_grads
from .kernels.megakernel import render_flat_hybrid_grad
from .render import (
    render,
    render_flat,
    render_flat_engine,
    render_hdr,
    render_hybrid_gpu,
    render_with_cpu,
    select_engine,
)
from .scene.bunny import bunny_camera, create_bunny_scene
from .scene.camera import Camera, default_camera, generate_rays, make_camera
from .scene.geometry import Spheres, Triangles, make_spheres, make_triangles
from .scene.materials import Materials, make_materials
from .scene.scene import (
    Scene,
    cornell_camera,
    create_cornell_box,
    create_mesh_scene,
    create_scene,
    make_scene,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Materials",
    "Scene",
    "Spheres",
    "Triangles",
    "attach_mxu",
    "attach_packed",
    "attach_superleaf",
    "attach_wide",
    "build_two_level",
    "bunny_camera",
    "camera_from_numpy",
    "colorimetry",
    "cornell_camera",
    "create_bunny_scene",
    "create_cornell_box",
    "create_mesh_scene",
    "create_scene",
    "default_camera",
    "generate_rays",
    "make_camera",
    "make_materials",
    "make_scene",
    "make_spheres",
    "make_triangles",
    "pcg",
    "render",
    "render_flat",
    "render_flat_engine",
    "render_flat_hybrid_grad",
    "render_hdr",
    "render_hybrid_gpu",
    "render_mse_loss_and_grads",
    "render_with_cpu",
    "rng",
    "scene_from_numpy",
    "select_engine",
    "vecmath",
]
