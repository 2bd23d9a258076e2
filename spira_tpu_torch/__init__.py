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
(``render_flat``, engine ``wavefront``, ``render_with_cpu``,
``render_flat_bvh_sorted``), whose threefry draws are JAX's own bits and
whose nearest hits on a packed scene on the card come from the packed-BVH
query kernel; and the differentiable mesh render
(``render_flat_hybrid_grad_mesh``: a packed-BVH kernel forward, the
wavefront's vector-Jacobian product backward); and the surface a user
starts from: the command line (``python -m spira_tpu_torch.cli render |
inverse | info``), the renderers behind it (``run_config``, the
progressive and adaptive renderers of :mod:`spira_tpu_torch.pipeline`),
the Adam inverse loop (``make_inverse_step``), the single-bounce previews
(``render_flat_preview``), ``RenderConfig`` and the EXR reader.  Scenes
and cameras are made on the card unless ``device="cpu"`` is asked for.
Nothing here imports JAX.
"""

from .accel.bvh import FlatBVH, build_bvh_for_triangles, build_two_level
from .accel.mxu import attach_mxu, attach_superleaf
from .accel.pairs import attach_packed
from .accel.wide import attach_wide
from .core import colorimetry, pcg, rng, vecmath
from .core.convert import camera_from_numpy, scene_from_numpy
from .diff.inverse import make_inverse_step
from .integrator.preview import render_flat_preview
from .kernels.grad_megakernel import render_mse_loss_and_grads
from .kernels.megakernel import render_flat_hybrid_grad
from .pipeline import run_config
from .render import (
    render,
    render_flat,
    render_flat_bvh_sorted,
    render_flat_engine,
    render_flat_hybrid_grad_mesh,
    render_hdr,
    render_hybrid_gpu,
    render_with_cpu,
    select_engine,
)
from .scene.bunny import bunny_camera, create_bunny_scene
from .scene.camera import Camera, default_camera, generate_rays, make_camera
from .scene.geometry import Spheres, Triangles, make_spheres, make_triangles
from .scene.materials import Materials, make_materials
from .scene.obj import cube, icosphere, load_obj_mesh, parse_obj
from .scene.scene import (
    Scene,
    cornell_camera,
    create_cornell_box,
    create_mesh_scene,
    create_scene,
    make_scene,
)
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "FlatBVH",
    "Materials",
    "RenderConfig",
    "Scene",
    "Spheres",
    "Triangles",
    "attach_mxu",
    "attach_packed",
    "attach_superleaf",
    "attach_wide",
    "build_bvh_for_triangles",
    "build_two_level",
    "bunny_camera",
    "camera_from_numpy",
    "colorimetry",
    "cornell_camera",
    "create_bunny_scene",
    "create_cornell_box",
    "create_mesh_scene",
    "create_scene",
    "cube",
    "default_camera",
    "generate_rays",
    "icosphere",
    "load_obj_mesh",
    "make_camera",
    "make_inverse_step",
    "make_materials",
    "make_scene",
    "make_spheres",
    "make_triangles",
    "parse_obj",
    "pcg",
    "render",
    "render_flat",
    "render_flat_bvh_sorted",
    "render_flat_engine",
    "render_flat_hybrid_grad",
    "render_flat_hybrid_grad_mesh",
    "render_flat_preview",
    "render_hdr",
    "render_hybrid_gpu",
    "render_mse_loss_and_grads",
    "render_with_cpu",
    "rng",
    "run_config",
    "scene_from_numpy",
    "select_engine",
    "vecmath",
]
