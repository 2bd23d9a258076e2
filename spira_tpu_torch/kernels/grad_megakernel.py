"""Adjoint of the path tracer: the MSE loss of a render and its gradients
from one call, and the vector-Jacobian product that serves as the backward
of :func:`.megakernel.render_flat_hybrid_grad`.

Counterpart of :mod:`spira_tpu.kernels.grad_megakernel`.  The work runs
two ways:

* :func:`render_grad_megakernel` — the hand-written CUDA kernels
  (``csrc/grad_megakernel.cu`` over the adjoint of ``csrc/adjoint.cuh``):
  in loss mode a forward kernel, one thread per pixel, then the VJP
  kernel, one thread per replayed sample; in VJP mode the VJP kernel
  alone.  For tables on the CPU it runs the plain version.
* :func:`grad_tables_plain` — the plain version: autograd through
  :func:`.megakernel.render_flat_fused` with ``remat=True`` at
  ``grad_spp`` samples.

Both return the cotangents of the packed (1, 20) camera, (S, 16) sphere and
(T, 24) triangle tables (:func:`.megakernel.pack_tables`); autograd through
the packing routes them to the scene's and camera's own fields, as
``jax.vjp`` of the packer does in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types

import torch

from .. import _build
from ..utils.profiling import annotate
from . import megakernel as mk

MAX_SPHERES = 16  # the JAX kernel's gradient-table rows
#: the camera fields the JAX kernel reads (the pinhole frame)
N_CAM_FIELDS = 12
#: the deepest path the adjoint's per-thread tape records
#: (``csrc/adjoint.cuh:kMaxTape``)
MAX_TAPE_DEPTH = 16
#: the shared memory one block of the VJP kernel may take on an H100
#: (227 KB): tables, their cotangent accumulators and the tape
_GRAD_SMEM_LIMIT = 232_448

_ARGTYPES = (
    ctypes.c_void_p,  # cam
    ctypes.c_void_p,  # spheres
    ctypes.c_int,  # n_spheres
    ctypes.c_void_p,  # tris
    ctypes.c_int,  # n_tris
    ctypes.c_void_p,  # pix: target (loss mode) or cotangent (VJP mode)
    ctypes.c_void_p,  # scratch: the cotangent loss mode writes
    ctypes.c_int,  # loss_mode
    ctypes.c_void_p,  # loss (1 double)
    ctypes.c_void_p,  # dcam
    ctypes.c_void_p,  # dsph
    ctypes.c_void_p,  # dtri
    ctypes.c_int,  # width
    ctypes.c_int,  # height
    ctypes.c_int,  # spp
    ctypes.c_int,  # grad_spp
    ctypes.c_int,  # max_depth
    ctypes.c_uint32,  # seed
    ctypes.c_float,  # du
    ctypes.c_float,  # dv
    ctypes.c_float,  # inv_spp
    ctypes.c_float,  # cot_scale
    ctypes.c_int,  # has_lens
    ctypes.c_void_p,  # stream
)


def grad_tables_plain(scene, camera, tables, pix, *, loss_mode, width,
                      height, spp, grad_spp, max_depth, seed=0,
                      inclusive_uv=True):
    """Plain version of :func:`render_grad_megakernel`, on the tables'
    device: returns ``(loss, dcam, dsph, dtri)``.

    Loss mode renders the forward at ``spp`` under ``no_grad``, takes the
    MSE against the (H*W, 3) target ``pix``, and replays with cotangent
    2·res/N; VJP mode takes ``pix`` as the cotangent of the image (loss is
    then ``None``).  The replay is autograd through the plain tracer at
    ``grad_spp`` samples, one checkpointed sample at a time."""
    kw = dict(width=width, height=height, max_depth=max_depth, seed=seed,
              inclusive_uv=inclusive_uv)
    loss = None
    cot = pix
    if loss_mode:
        with torch.no_grad():
            res = mk.render_flat_fused(scene, camera, spp=spp, tables=tables,
                                       **kw) - pix
            loss = (res * res).mean()
            cot = res * (2.0 / res.numel())
    leaves = [t.detach().requires_grad_() for t in tables]
    with torch.enable_grad():
        img = mk.render_flat_fused(scene, camera, spp=grad_spp, remat=True,
                                   tables=leaves, **kw)
        grads = torch.autograd.grad(img, leaves, cot, allow_unused=True)
    return (loss, *(torch.zeros_like(t) if g is None else g
                    for g, t in zip(grads, leaves)))


def _check_pix(pix, device, n):
    if pix.device != device:
        raise ValueError(f"target/cotangent is on {pix.device}, the scene on "
                         f"{device}")
    if pix.dtype != torch.float32 or tuple(pix.shape) != (n, 3):
        raise ValueError(f"target/cotangent must be float32 ({n}, 3), got "
                         f"{pix.dtype} {tuple(pix.shape)}")
    if not pix.is_contiguous():
        raise ValueError("target/cotangent must be contiguous")


def render_grad_megakernel(scene, camera, tables, pix, *, loss_mode, width,
                           height, spp, grad_spp, max_depth, seed=0,
                           inclusive_uv=True):
    """Loss and table cotangents → ``(loss, dcam, dsph, dtri)``.

    ``tables`` are :func:`.megakernel.pack_tables` of ``scene`` and
    ``camera``.  In loss mode ``pix`` is the (H*W, 3) bottom-up target: the
    kernel renders at ``spp``, returns the MSE (a float32 scalar) and the
    gradients of it, replaying the first ``grad_spp ≤ spp`` samples.  In
    VJP mode ``pix`` is the cotangent of the ``spp``-sample image and the
    gradients are those of its ``grad_spp``-sample replay; loss is ``None``.

    Tables on a CUDA device launch ``csrc/grad_megakernel.cu`` (built on
    first use) and add one to ``render_grad_megakernel.launches``; in loss
    mode its forward kernel runs first and adds one to
    ``loss_forward.launches``.  A build or launch failure raises.  Tables
    on the CPU run :func:`grad_tables_plain`.
    """
    mk._check_fused_supported(scene)
    device = scene.device
    kw = dict(loss_mode=loss_mode, width=width, height=height, spp=spp,
              grad_spp=grad_spp, max_depth=max_depth, seed=seed,
              inclusive_uv=inclusive_uv)
    if device.type == "cpu":
        return grad_tables_plain(scene, camera, tables, pix, **kw)
    mk._check_launch_args(device, width, height, spp, max_depth,
                          "render_grad_megakernel")
    if grad_spp < 1 or (loss_mode and grad_spp > spp):
        raise ValueError(f"grad_spp must be >= 1 (and <= spp in loss mode), "
                         f"got {grad_spp} with spp {spp}")
    if max_depth > MAX_TAPE_DEPTH:
        raise ValueError(f"max_depth {max_depth} is over the adjoint's "
                         f"{MAX_TAPE_DEPTH}-bounce tape")
    with annotate("spira.pack"):
        cam, sph, tri = (t.detach() for t in tables)
        mk._check_table("camera table", cam, device, mk.N_CAM_FIELDS)
        mk._check_table("sphere table", sph, device, mk.N_SPHERE_FIELDS)
        mk._check_table("triangle table", tri, device, mk.N_TRI_FIELDS)
        n = width * height
        _check_pix(pix, device, n)
        # the kernel's own count of a block's bytes: tables, one copy of
        # their cotangent accumulators (it keeps more only where they
        # fit), the tape
        smem = _build.entry("grad_megakernel", "spira_grad_smem",
                            (ctypes.c_int,) * 3)(sph.shape[0], tri.shape[0],
                                                 max_depth)
        if smem > _GRAD_SMEM_LIMIT:
            raise ValueError(
                f"scene tables, their gradients and the depth-{max_depth} "
                f"tape take {smem} bytes, over the adjoint kernel's "
                f"{_GRAD_SMEM_LIMIT}-byte shared-memory budget "
                "(_GRAD_SMEM_LIMIT)")
        loss = torch.zeros(1, dtype=torch.float64, device=device)
        dcam, dsph, dtri = (torch.zeros_like(t) for t in (cam, sph, tri))
        scratch = (torch.empty((n, 3), dtype=torch.float32, device=device)
                   if loss_mode else None)
    du, dv = mk._uv_scale(width, height, inclusive_uv)
    cot_scale = (1.0 / (3 * n * grad_spp) if loss_mode
                 else mk._inv_spp(grad_spp))
    fn = _build.entry("grad_megakernel", "spira_grad_render", _ARGTYPES)
    with annotate("spira.kernel.render_grad_megakernel"), \
            torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            cam.data_ptr(), sph.data_ptr(), sph.shape[0], tri.data_ptr(),
            tri.shape[0], pix.data_ptr(),
            None if scratch is None else scratch.data_ptr(), int(loss_mode),
            loss.data_ptr(),
            dcam.data_ptr(), dsph.data_ptr(), dtri.data_ptr(), width, height,
            spp, grad_spp, max_depth, seed & 0xFFFFFFFF, du, dv,
            mk._inv_spp(spp), cot_scale, int(camera.has_lens), stream,
        )
    mk._launch_error("grad_megakernel", err)
    render_grad_megakernel.launches += 1
    loss_forward.launches += int(loss_mode)
    return ((loss[0] / (3 * n)).to(torch.float32) if loss_mode else None,
            dcam, dsph, dtri)


#: Kernel launches since the count was last reset (set it to 0 to reset).
render_grad_megakernel.launches = 0
#: Launches of loss mode's forward kernel (``grad_loss_forward``), which
#: :func:`render_grad_megakernel` makes before the VJP kernel; set
#: ``loss_forward.launches`` to 0 to reset.
loss_forward = types.SimpleNamespace(launches=0)


# ----------------------------------------------------------------------------
# The loss entry point
# ----------------------------------------------------------------------------

_GROUPS = ("spheres", "triangles", "materials")


def _lift(obj, leaves):
    """Copy of a tensor dataclass whose float tensors are fresh leaves that
    require grad (appended to ``leaves``)."""
    fields = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if torch.is_tensor(value) and value.is_floating_point():
            value = value.detach().requires_grad_()
            leaves.append(value)
        fields[f.name] = value
    return dataclasses.replace(obj, **fields)


def _cotangent(obj, grads):
    """The lifted dataclass with each leaf replaced by its gradient (zeros
    where none flows) and every other field by ``None``."""
    fields = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        leaf = torch.is_tensor(value) and value.requires_grad
        fields[f.name] = grads[id(value)] if leaf else None
    return dataclasses.replace(obj, **fields)


def _check_loss_scene(scene, camera):
    n_spheres = scene.spheres.count
    if n_spheres == 0 or n_spheres > MAX_SPHERES:
        raise ValueError(f"render_mse_loss_and_grads supports 1..{MAX_SPHERES}"
                         f" spheres (got {n_spheres})")
    if scene.triangles.count > 0:
        raise ValueError("render_mse_loss_and_grads is sphere-only; "
                         "differentiate a triangle scene through "
                         "render_flat_hybrid_grad")
    if camera.has_lens:
        raise ValueError(f"render_mse_loss_and_grads traces a pinhole "
                         f"camera only (the JAX kernel reads {N_CAM_FIELDS} "
                         f"camera fields and would trace a lens as a "
                         f"pinhole); differentiate a thin-lens camera "
                         f"through render_flat_hybrid_grad")


def _loss_and_grads(grad_fn, scene, camera, target_flat, *, width, height,
                    spp, grad_spp, max_depth, seed, inclusive_uv):
    _check_loss_scene(scene, camera)
    leaves = []
    scene_l = dataclasses.replace(
        scene, **{g: _lift(getattr(scene, g), leaves) for g in _GROUPS})
    camera_l = _lift(camera, leaves)
    tables = mk.pack_tables(scene_l, camera_l)
    target = torch.as_tensor(target_flat, dtype=torch.float32,
                             device=scene.device).contiguous()
    loss, *dtables = grad_fn(
        scene, camera, [t.detach() for t in tables], target, loss_mode=True,
        width=width, height=height, spp=spp,
        grad_spp=spp if grad_spp is None else grad_spp, max_depth=max_depth,
        seed=seed, inclusive_uv=inclusive_uv)
    grads = torch.autograd.grad(tables, leaves, dtables, allow_unused=True)
    by_id = {id(leaf): torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)}
    d_scene = dataclasses.replace(
        scene_l, bvh=None, packed=None,
        **{g: _cotangent(getattr(scene_l, g), by_id) for g in _GROUPS})
    return loss, d_scene, _cotangent(camera_l, by_id)


def render_mse_loss_and_grads(
    scene,
    camera,
    target_flat,
    *,
    width: int,
    height: int,
    spp: int = 16,
    grad_spp: int | None = None,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """MSE loss of a render against ``target_flat`` ((H*W, 3) bottom-up
    HDR) and its gradients, from one call of the adjoint kernels on the
    card (the forward kernel, then the VJP kernel; the plain version on the
    CPU).

    Returns ``(loss, d_scene, d_camera)``: ``d_scene`` and ``d_camera`` are
    dataclasses of the scene's and camera's types whose float fields hold
    their gradients (zeros where none flows) and whose other fields are
    ``None``.  The forward runs at ``spp`` samples, the gradient replays
    the first ``grad_spp`` (default ``spp``).  Takes 1..16 spheres, no
    triangles and a pinhole camera, and raises ``ValueError`` otherwise.
    """
    return _loss_and_grads(
        render_grad_megakernel, scene, camera, target_flat, width=width,
        height=height, spp=spp, grad_spp=grad_spp, max_depth=max_depth,
        seed=seed, inclusive_uv=inclusive_uv)


def render_mse_loss_and_grads_plain(
    scene,
    camera,
    target_flat,
    *,
    width: int,
    height: int,
    spp: int = 16,
    grad_spp: int | None = None,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """The plain version of :func:`render_mse_loss_and_grads`, on any
    device: the forward through the plain tracer, the gradients by autograd
    through it (:func:`grad_tables_plain`)."""
    return _loss_and_grads(
        grad_tables_plain, scene, camera, target_flat, width=width,
        height=height, spp=spp, grad_spp=grad_spp, max_depth=max_depth,
        seed=seed, inclusive_uv=inclusive_uv)
