"""Spectral packed-BVH path tracer (mesh scenes, physical semantics): the
host side, the plain PyTorch version, and the wrapper of the CUDA kernel.

Counterpart of :mod:`spira_tpu.kernels.spectral_bvh`.  It composes the two
tracers that exist: the packed walk of :mod:`.bvh_megakernel` supplies the
nearest triangle (t, normal, material id), and the spectral tracer of
:mod:`.spectral_fused` consumes it through its ``intersect_fn`` hook, as the
RGB BVH path plugs into ``megakernel.trace_tile``.  Spheres go first: their
nearest hit seeds ``best_t`` and culls the walk.

* :func:`render_flat_spectral_bvh_megakernel` — the CUDA kernel
  (``csrc/spectral_megakernel.cu``, ``spira_spectral_bvh_render``) for
  scenes on a CUDA device; for scenes on the CPU,
  :func:`render_flat_spectral_bvh_fused`.

The TPU kernel's ``tile_h`` and ``pops_per_iter`` shape the Pallas packet
walk and are not ported (ROADMAP.md ground rules).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..core import colorimetry as cl
from . import bvh_megakernel as bk
from . import megakernel as mk
from . import spectral_fused as sf
# the (M, 29) material table lives with the record layout in spectral_fused
from .spectral_fused import N_MAT_SPEC, N_SPH_SPEC, pack_materials_spectral


def make_packed_intersect_spectral(spheres, packed, mat_table):
    """The ``intersect_fn`` for :func:`spectral_fused.trace_tile_spectral`
    over a packed mesh scene: the sphere loop over ``spheres`` (S, 33)
    seeds ``best_t``, the packed walk beats it, and triangle hits take
    their material record from ``mat_table`` (M, 29) by material id."""
    brute_spheres = sf.make_brute_intersect_spectral(spheres)

    def intersect(o3, d3, active=None):
        hit_s, t_s, n_s, mat_s = brute_spheres(o3, d3, active)
        t, nrm, mid, _ = bk.packed_walk(
            packed, torch.stack(o3, -1), torch.stack(d3, -1),
            torch.where(hit_s, t_s, mk.INF), active)
        tri = mid >= 0.0
        hit = t < mk.INF
        n3 = tuple(torch.where(tri, nrm[:, k], n_s[k]) for k in range(3))
        mat = torch.where(tri[:, None], mat_table[mid.clamp(min=0.0).long()],
                          mat_s)
        return hit, torch.where(hit, t, 1.0), n3, mat

    return intersect


def _tables(scene):
    mat = pack_materials_spectral(scene.materials)
    return sf._sphere_records(scene, mat), mat


def render_flat_spectral_bvh_fused(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Plain-PyTorch spectral packed-BVH render → flat (H*W, 3) bottom-up
    linear-sRGB buffer, on the scene's device.  Same math, walk and RNG as
    the CUDA kernel; a scene with no spheres works."""
    packed = bk._require_tree(scene)
    sph, mat = _tables(scene)
    return sf.render_traced(
        scene, camera, width=width, height=height, spp=spp,
        max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
        spheres=sph,
        intersect_fn=make_packed_intersect_spectral(sph, packed, mat),
    )


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    _VP, _VP,  # cam, sky
    _VP, _I,  # spheres, n_spheres
    _VP, _I,  # mats, n_mats
    _VP, _VP, _I, _I,  # pairs, tri_rows, root, form_bw
    _VP, _I, _I, _I, _I,  # out, width, height, spp, max_depth
    ctypes.c_uint32, _F, _F, _F, _F, _I,  # seed, du, dv, inv_spp,
                                          # film_scale, has_lens
    _VP,  # stream
)


def render_flat_spectral_bvh_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Spectral packed-BVH render → flat (H*W, 3) bottom-up linear-sRGB
    buffer.

    Requires ``scene.packed`` (:func:`spira_tpu_torch.accel.pairs.
    attach_packed`); the triangle count is unlimited.  A scene on a CUDA
    device launches ``spira_spectral_bvh_render`` (built on first use),
    which writes XYZ, and adds one to
    ``render_flat_spectral_bvh_megakernel.launches``; a scene on the CPU
    runs :func:`render_flat_spectral_bvh_fused`.  Same spectral estimator
    and PCG streams as :func:`spectral_fused.render_flat_fused_spectral`.
    Any other device, and any input the kernel does not take, raises.
    """
    packed = bk._require_tree(scene)
    device = scene.device
    if device.type == "cpu":
        return render_flat_spectral_bvh_fused(
            scene, camera, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
        )
    mk._check_launch_args(device, width, height, spp, max_depth,
                          "render_flat_spectral_bvh_megakernel")
    with torch.no_grad():
        cam = mk.pack_camera(camera).contiguous()
        sph, mat = (t.contiguous() for t in _tables(scene))
    sky = sf.sky_table(device)
    mk._check_table("camera table", cam, device, mk.N_CAM_FIELDS)
    mk._check_table("sphere table", sph, device, N_SPH_SPEC)
    mk._check_table("material table", mat, device, N_MAT_SPEC)
    bk._check_tree_tables(packed, device)
    mk._check_smem(cam, sky, sph, mat)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    out = torch.empty((height * width, 3), dtype=torch.float32, device=device)
    fn = _build.entry("spectral_megakernel", "spira_spectral_bvh_render",
                      _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            cam.data_ptr(), sky.data_ptr(), sph.data_ptr(), sph.shape[0],
            mat.data_ptr(), mat.shape[0], packed.pairs.data_ptr(),
            packed.tri_rows.data_ptr(), packed.root,
            int(packed.form == "bw"), out.data_ptr(), width, height, spp,
            max_depth, seed & 0xFFFFFFFF, du, dv, mk._inv_spp(spp),
            sf.film_scale(), int(camera.has_lens), stream,
        )
    mk._launch_error("spectral_bvh_megakernel", err)
    render_flat_spectral_bvh_megakernel.launches += 1
    # XYZ -> linear sRGB outside the kernel, as the JAX package does
    return cl.xyz_to_rgb(out)


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_flat_spectral_bvh_megakernel.launches = 0
