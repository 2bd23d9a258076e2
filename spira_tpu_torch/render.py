"""Top-level render entry points: engine choice, HDR render, tone-mapped
image.

Counterpart of the entry points of :mod:`spira_tpu.render`: physical and
reference semantics, RGB or spectral, full shading.  The engines are

* ``cuda``     — the hand-written CUDA megakernel (with ``spectral=True``,
  the spectral megakernel), for sphere and small-triangle scenes (at most
  ``FUSED_TRI_LIMIT`` triangles, no BVH) on a CUDA device (the plain
  tracer for scenes on the CPU);
* ``cuda_bvh`` — the hand-written CUDA packed-BVH kernel, for mesh scenes
  with ``packed`` tables on a CUDA device (the plain packed walk on the
  CPU), RGB only;
* ``cuda_spectral_bvh`` — the hand-written CUDA spectral packed-BVH kernel
  (the plain version on the CPU); it renders spectrally whatever
  ``spectral`` says, as the JAX package's ``pallas_spectral_bvh`` does;
* ``cuda_mxu`` — the streaming superleaf kernel (every ray tests every
  128-triangle block; JAX's ``pallas_mxu``), RGB only, packing
  ``scene.wide`` with ``attach_mxu`` when it holds no MXUBVH;
* ``cuda_bvh_mxu`` — the packed-BVH kernel over a pair tree whose leaves
  are superleaf blocks (JAX's ``pallas_bvh_mxu``), RGB only, packing
  ``scene.wide`` with ``attach_superleaf`` when it holds no SuperleafBVH;
* ``fused``    — the plain PyTorch tracer (RGB or spectral), on any device;
* ``wavefront`` — the masked wavefront estimator (:func:`render_flat`,
  threefry draws): any scene, reference semantics, spectral transport.
  On a packed scene on the card its nearest hits come from CUDA kernel #3
  (``make_sorted_tile_intersect``); elsewhere from the plain traversal of
  :mod:`spira_tpu_torch.accel.traverse` or brute force;
* ``bvh_sorted`` — the same estimator with its nearest hits from the
  packed-BVH query on any device (:func:`render_flat_bvh_sorted`; packed
  scenes, forward only).

Every engine but ``wavefront`` renders physical semantics only.
:func:`render_flat_hybrid_grad_mesh` is the differentiable mesh render: a
kernel forward, the wavefront's vector-Jacobian product backward.
``engine="auto"`` never picks the two superleaf engines, as in JAX: they
are the retired experiments of :mod:`spira_tpu_torch.experiments`.
``render(shading="preview"|"normal")`` takes the single-bounce renderer
of :mod:`spira_tpu_torch.integrator.preview`.  :func:`accumulate_rows`,
:func:`accumulate_row_set` and :func:`accumulate_block_set` are the
wavefront's sample loops over a row range, a row set and a block set, for
the renderers of :mod:`spira_tpu_torch.pipeline`.

The sharded paths of the JAX renderer raise ``NotImplementedError`` naming
the ROADMAP item (queue 1) that brings them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .accel.mxu import MXUBVH, SuperleafBVH, attach_mxu, attach_superleaf
from .core import rng as srng
from .core.types import requires_grad
from .integrator.path_trace import trace
from .integrator.spectral import trace_spectral
from .io import image as img_io
from .kernels.bvh_megakernel import (
    make_sorted_tile_intersect,
    render_flat_bvh_megakernel,
)
from .kernels.megakernel import (
    FUSED_TRI_LIMIT,
    render_flat_fused,
    render_flat_megakernel,
    true_divide,
)
from .kernels.mxu_megakernel import render_flat_mxu_megakernel
from .kernels.spectral_bvh import render_flat_spectral_bvh_megakernel
from .kernels.spectral_fused import (
    render_flat_fused_spectral,
    render_flat_spectral_megakernel,
)
from .scene.camera import generate_rays


def render_flat(scene, camera, *, width: int, height: int, spp: int = 16,
                max_depth: int = 4, seed: int = 0,
                semantics: str = "physical", inclusive_uv: bool = True,
                spectral: bool = False, grad_hook: bool = True):
    """Render with the wavefront estimator to a flat (H*W, 3) bottom-up
    HDR radiance buffer (the mean of ``spp`` samples), on the scene's
    device.

    Each sample generates and traces one (H*W,) wavefront.  A scene with
    packed tables on a CUDA device, in physical semantics, takes every
    bounce's nearest hit from CUDA kernel #3 through
    :func:`make_sorted_tile_intersect` (``grad_hook`` picks its
    differentiable form), where JAX's ``render_flat`` takes it from Pallas
    #3 on the TPU; other scenes take :func:`spira_tpu_torch.integrator.
    intersect.intersect_scene`.
    """
    return wavefront_mean(scene, camera,
                          wavefront_hook(scene, semantics, grad=grad_hook),
                          width=width, height=height, spp=spp,
                          max_depth=max_depth, seed=seed,
                          semantics=semantics, inclusive_uv=inclusive_uv,
                          spectral=spectral)


def wavefront_hook(scene, semantics: str = "physical", grad: bool = False):
    """The wavefront's nearest-hit hook for ``scene``: CUDA kernel #3
    through :func:`make_sorted_tile_intersect` (``grad`` picks its
    differentiable form) for a scene with packed tables on a CUDA device
    in physical semantics, where JAX takes Pallas #3 on the TPU; ``None``
    (:func:`spira_tpu_torch.integrator.intersect.intersect_scene`) for
    every other scene."""
    if (scene.packed is not None and semantics == "physical"
            and scene.device.type == "cuda"):
        return make_sorted_tile_intersect(grad=grad)
    return None


def render_flat_bvh_sorted(scene, camera, *, width: int, height: int,
                           spp: int = 16, max_depth: int = 4, seed: int = 0,
                           inclusive_uv: bool = True,
                           spectral: bool = False):
    """The wavefront estimator with every bounce's nearest hits from the
    packed-BVH query (:func:`make_sorted_tile_intersect`, ``grad=False``):
    CUDA kernel #3 on the card, its plain version on the CPU; physical
    semantics, RGB or spectral; flat (H*W, 3) bottom-up HDR.  Forward
    only, and it requires ``scene.packed``.

    The counterpart of JAX's ``render_flat_bvh_sorted``, less its TPU
    knobs (``sort``, ``tile_h``, ``pops_per_iter``, ``interpret``): JAX
    regroups each bounce's rays by (dead, direction octant) so that a
    TPU packet's rays cull together; a per-ray walk's nearest hit does not
    depend on the rays' order, so nothing is sorted.  On the card it is
    ``render_flat(..., grad_hook=False)``, to the bit.
    """
    if scene.packed is None:
        raise ValueError("render_flat_bvh_sorted needs scene.packed; call "
                         "spira_tpu_torch.accel.pairs.attach_packed")
    return wavefront_mean(scene, camera, make_sorted_tile_intersect(),
                          width=width, height=height, spp=spp,
                          max_depth=max_depth, seed=seed,
                          inclusive_uv=inclusive_uv, spectral=spectral)


def wavefront_mean(scene, camera, intersect_fn, *, width: int, height: int,
                   spp: int, max_depth: int, seed: int = 0,
                   semantics: str = "physical", inclusive_uv: bool = True,
                   spectral: bool = False, checkpoint_samples: bool = True):
    """The wavefront estimator's mean of ``spp`` samples over the whole
    frame, its nearest hits from ``intersect_fn`` (``None``:
    ``intersect_scene``): the body of :func:`render_flat`,
    :func:`render_flat_bvh_sorted` and :func:`mesh_replay`."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    acc = accumulate_rows(
        scene, camera, srng.base_key(seed), width=width, height=height,
        row_start=0, n_rows=height, sample_offset=0, n_samples=spp,
        max_depth=max_depth, semantics=semantics, inclusive_uv=inclusive_uv,
        spectral=spectral, intersect_fn=intersect_fn,
        checkpoint_samples=checkpoint_samples)
    return true_divide(acc, float(spp))


def accumulate_rows(scene, camera, base_key, *, width: int, height: int,
                    row_start: int, n_rows: int, sample_offset: int,
                    n_samples: int, max_depth: int, semantics: str,
                    inclusive_uv: bool = True, spectral: bool = False,
                    intersect_fn=None, checkpoint_samples: bool = True,
                    init=None):
    """The sum of ``n_samples`` radiance estimates for the rows
    ``row_start .. row_start + n_rows``: (n_rows*width, 3).  Sample ``k``
    draws from ``fold_in(sample_key(base_key, sample_offset + k),
    row_start)``, so tiles of one image draw decorrelated randomness;
    callers divide by the total spp.  ``init`` (an (n_rows*width, 3)
    tensor, not written to) is the sum to add the samples to, in sample
    order: a render in chunks that passes each chunk the sum so far adds
    exactly what one call over every sample adds.

    With ``checkpoint_samples``, when a gradient is being taken (grad mode
    on and a tensor of the scene or camera requires grad), each sample is
    a checkpoint (non-reentrant ``torch.utils.checkpoint``), as JAX's
    ``@jax.checkpoint sample_step`` makes it: reverse mode keeps one
    (N, 3) accumulator a sample and replays the sample for its gradient,
    redrawing its threefry bits from the keys, which are Python ints (no
    RNG state kept).  A value-only call checkpoints nothing and adds no
    operation.
    """
    acc = (torch.zeros((n_rows * width, 3), dtype=torch.float32,
                       device=camera.origin.device) if init is None
           else init)
    remat = (checkpoint_samples and torch.is_grad_enabled()
             and requires_grad(scene, camera))

    def sample(k):
        skey = srng.fold_in(srng.sample_key(base_key, sample_offset + k),
                            row_start)
        origins, dirs = generate_rays(camera, width, height, skey,
                                      inclusive_uv=inclusive_uv,
                                      row_start=row_start, n_rows=n_rows)
        return _trace(scene, origins, dirs, skey, max_depth, semantics,
                      spectral, intersect_fn)

    for k in range(n_samples):
        acc = acc + (checkpoint(sample, k, use_reentrant=False,
                                preserve_rng_state=False)
                     if remat else sample(k))
    return acc


def _trace(scene, origins, dirs, skey, max_depth, semantics, spectral,
           intersect_fn):
    if spectral:
        return trace_spectral(scene, origins, dirs, skey,
                              max_depth=max_depth, intersect_fn=intersect_fn)
    return trace(scene, origins, dirs, skey, max_depth=max_depth,
                 semantics=semantics, intersect_fn=intersect_fn)


#: Rec.709 luma weights: the adaptive sampler's convergence statistic
LUMA = (0.2126, 0.7152, 0.0722)


def accumulate_row_set(scene, camera, base_key, rows, sample_base, *,
                       width: int, height: int, n_samples: int,
                       max_depth: int, semantics: str = "physical",
                       inclusive_uv: bool = True, spectral: bool = False,
                       intersect_fn=None):
    """The sums of ``n_samples`` radiance estimates over a SET of image
    rows, the adaptive sampler's dispatch unit: ``rows`` is an (R,)
    integer tensor or sequence of rows (counted from the bottom), and
    sample ``k`` draws from ``sample_key(base_key, sample_base + k)``,
    fresh every round and shared by the round's rows (rays decorrelate by
    their position in the draw).

    Returns ``(acc (R*W, 3), lum (R*W,), lum2 (R*W,))``: the radiance sum
    and the sums of each estimate's luminance (``LUMA``) and its square,
    which the convergence test needs.  Forward only.
    """
    rows = torch.as_tensor(rows, device=camera.origin.device).long()
    return _accumulate_set(scene, camera, base_key, sample_base,
                           int(rows.shape[0]) * width, dict(rows=rows),
                           width=width, height=height, n_samples=n_samples,
                           max_depth=max_depth, semantics=semantics,
                           inclusive_uv=inclusive_uv, spectral=spectral,
                           intersect_fn=intersect_fn)


def accumulate_block_set(scene, camera, base_key, blocks, sample_base, *,
                         width: int, height: int, n_samples: int,
                         max_depth: int, semantics: str = "physical",
                         inclusive_uv: bool = True, spectral: bool = False,
                         intersect_fn=None, block_w: int = 128):
    """:func:`accumulate_row_set` over a SET of ``block_w``-pixel row
    segments instead (block id = row * (W // block_w) + col_block), so
    that segments, not whole rows, retire independently.

    Returns ``(acc (B*block_w, 3), lum (B*block_w,), lum2 (B*block_w,))``.
    """
    blocks = torch.as_tensor(blocks, device=camera.origin.device).long()
    return _accumulate_set(scene, camera, base_key, sample_base,
                           int(blocks.shape[0]) * block_w,
                           dict(blocks=blocks, block_w=block_w),
                           width=width, height=height, n_samples=n_samples,
                           max_depth=max_depth, semantics=semantics,
                           inclusive_uv=inclusive_uv, spectral=spectral,
                           intersect_fn=intersect_fn)


def _accumulate_set(scene, camera, base_key, sample_base, n, raygen, *,
                    width, height, n_samples, max_depth, semantics,
                    inclusive_uv, spectral, intersect_fn):
    """The sums of :func:`accumulate_row_set` over the ``n`` rays that
    ``generate_rays(**raygen)`` makes."""
    device = camera.origin.device
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    lum = torch.zeros((n,), dtype=torch.float32, device=device)
    lum2 = torch.zeros((n,), dtype=torch.float32, device=device)
    for k in range(n_samples):
        skey = srng.sample_key(base_key, sample_base + k)
        origins, dirs = generate_rays(camera, width, height, skey,
                                      inclusive_uv=inclusive_uv, **raygen)
        radiance = _trace(scene, origins, dirs, skey, max_depth, semantics,
                          spectral, intersect_fn)
        y = (radiance[:, 0] * LUMA[0] + radiance[:, 1] * LUMA[1]
             + radiance[:, 2] * LUMA[2])
        acc = acc + radiance
        lum = lum + y
        lum2 = lum2 + y * y
    return acc, lum, lum2


def _render_flat_mxu(scene, camera, **kw):
    if not isinstance(scene.wide, MXUBVH):
        # host-side packing; attach once outside render loops
        scene = attach_mxu(scene)
    return render_flat_mxu_megakernel(scene, camera, **kw)


def _render_flat_bvh_mxu(scene, camera, **kw):
    if not isinstance(scene.wide, SuperleafBVH):
        # host-side packing; attach once outside render loops
        scene = attach_superleaf(scene)
    return render_flat_bvh_megakernel(scene, camera, mxu_leaf=True, **kw)


ENGINES = ("cuda", "cuda_bvh", "cuda_spectral_bvh", "cuda_mxu",
           "cuda_bvh_mxu", "fused", "wavefront", "bvh_sorted")
#: engine -> (RGB render, spectral render)
_ENGINE_FNS = {
    "cuda": (render_flat_megakernel, render_flat_spectral_megakernel),
    "cuda_bvh": (render_flat_bvh_megakernel, None),
    "cuda_spectral_bvh": (render_flat_spectral_bvh_megakernel,) * 2,
    "cuda_mxu": (_render_flat_mxu, None),
    "cuda_bvh_mxu": (_render_flat_bvh_mxu, None),
    "fused": (render_flat_fused, render_flat_fused_spectral),
}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to spira_tpu_torch yet (ROADMAP.md queue 1, "
        f"{item})"
    )


def _unknown_engine(engine: str, engines=ENGINES):
    return (f"engine {engine!r} is not an engine of spira_tpu_torch, whose "
            f"engines are {', '.join(engines)}: JAX's 'pallas*' engines are "
            "named 'cuda*' here, and its '*_interpret' engines are TPU "
            "knobs that are not ported (ROADMAP.md, ground rules)")


def select_engine(
    scene, semantics: str, spectral: bool, engine: str = "auto", camera=None
):
    """Resolve the execution engine, as JAX's ``select_engine`` does with
    ``cuda``/``cuda_bvh`` for ``pallas``/``pallas_bvh``: a scene with
    packed BVH tables on a CUDA device in physical semantics takes
    ``cuda_bvh`` (``cuda_spectral_bvh`` with ``spectral``); a scene of
    spheres and at most ``FUSED_TRI_LIMIT`` triangles with no BVH, in
    physical semantics, ``cuda`` on a CUDA device and ``fused`` on the
    CPU; everything else (reference semantics, BVH scenes on the CPU or
    without packed tables, larger brute-force scenes) ``wavefront``.  A
    named engine is returned as it is."""
    if engine != "auto":
        if engine not in ENGINES:
            raise NotImplementedError(_unknown_engine(engine))
        return engine
    on_card = scene.device.type == "cuda"
    if scene.packed is not None and semantics == "physical" and on_card:
        return "cuda_spectral_bvh" if spectral else "cuda_bvh"
    fusable = (
        scene.bvh is None
        and scene.triangles.count <= FUSED_TRI_LIMIT
        and (scene.spheres.count + scene.triangles.count) > 0
    )
    if fusable and semantics == "physical":
        return "cuda" if on_card else "fused"
    return "wavefront"


def render_flat_engine(
    scene, camera, *, width, height, spp=16, max_depth=4, seed=0,
    semantics="physical", inclusive_uv=True, spectral=False, engine="auto",
):
    """Flat (H*W, 3) bottom-up HDR render with engine dispatch: linear
    RGB, or with ``spectral`` linear sRGB from the spectral XYZ film.  The
    fused engines draw from the PCG4D stream, the wavefront engine from
    threefry: their images agree statistically, not bitwise."""
    engine = select_engine(scene, semantics, spectral, engine, camera=camera)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv)
    if engine == "wavefront":
        return render_flat(scene, camera, semantics=semantics,
                           spectral=spectral, **kw)
    if semantics != "physical":
        raise ValueError(
            f"engine {engine!r} renders physical semantics only; use "
            "engine='wavefront' (or 'auto') for reference semantics")
    if engine == "bvh_sorted":
        return render_flat_bvh_sorted(scene, camera, spectral=spectral, **kw)
    fn = _ENGINE_FNS[engine][bool(spectral)]
    if fn is None:
        raise ValueError(
            f"engine {engine!r} renders RGB only; use "
            "engine='cuda_spectral_bvh' (or 'auto') for spectral mesh scenes"
        )
    return fn(scene, camera, **kw)


def render_hdr(scene, camera, width, height, **kw):
    """Render to an (H, W, 3) top-down HDR image tensor."""
    flat = render_flat_engine(scene, camera, width=width, height=height, **kw)
    return img_io.assemble_image(flat, width, height)


def render(
    scene,
    camera,
    width: int,
    height: int,
    *,
    samples_per_pixel: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    semantics: str = "physical",
    tonemap: str = "gamma",
    inclusive_uv: bool = True,
    spectral: bool = False,
    engine: str = "auto",
    shading: str = "full",
    output_path: str | None = None,
) -> np.ndarray:
    """Render, tone map, optionally save; returns (H, W, 3) uint8, top-down.

    ``shading="preview"``/``"normal"`` take the single-bounce quick-look
    renderer (:func:`spira_tpu_torch.integrator.preview.
    render_flat_preview`), which ignores the sampling and engine
    arguments.  ``output_path`` ending in ``.exr`` saves the HDR image,
    ``.ppm`` a PPM, anything else a PNG.
    """
    if shading != "full":
        from .integrator.preview import render_flat_preview

        hdr = img_io.assemble_image(render_flat_preview(
            scene, camera, width=width, height=height, seed=seed,
            shading=shading, inclusive_uv=inclusive_uv), width, height)
    else:
        hdr = render_hdr(
            scene,
            camera,
            width,
            height,
            spp=samples_per_pixel,
            max_depth=max_depth,
            seed=seed,
            semantics=semantics,
            inclusive_uv=inclusive_uv,
            spectral=spectral,
            engine=engine,
        )
    out = img_io.to_uint8(img_io.TONEMAPS[tonemap](hdr))
    if output_path is not None:
        if output_path.endswith(".exr"):
            img_io.save_exr(output_path, hdr)
        elif output_path.endswith(".ppm"):
            img_io.save_ppm(output_path, out)
        else:
            img_io.save_png(output_path, out)
    return out


def render_hybrid_gpu(scene, camera, width, height, **kw):
    """Compatibility alias for the reference's accelerated entry point
    (``render_hybrid_gpu``): :func:`render` with engine dispatch."""
    return render(scene, camera, width, height, **kw)


def render_with_cpu(scene, camera, width, height, **kw):
    """Compatibility alias for the reference's CPU fallback renderer
    (``render_with_cpu``): the wavefront engine in bug-compatible
    reference semantics, on the scene's device."""
    kw.setdefault("semantics", "reference")
    kw.setdefault("engine", "wavefront")
    return render(scene, camera, width, height, **kw)


# ----------------------------------------------------------------------------
# The differentiable mesh render: a kernel forward, the wavefront's VJP as
# its backward
# ----------------------------------------------------------------------------

#: the forward engines of render_flat_hybrid_grad_mesh (JAX's
#: "pallas_bvh", "pallas_bvh_mxu" and "wavefront")
MESH_GRAD_ENGINES = ("cuda_bvh", "cuda_bvh_mxu", "wavefront")
#: its backward's nearest-hit providers
MESH_GRAD_BWD = ("packet", "wavefront")
_GRAD_GROUPS = ("materials", "spheres", "triangles")


def _float_fields(scene, camera):
    """[(group, field)] of every float tensor field of the scene's
    materials, spheres and triangles, and of the camera."""
    groups = [(g, getattr(scene, g)) for g in _GRAD_GROUPS]
    return [(g, f.name) for g, obj in (*groups, ("camera", camera))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
            and getattr(obj, f.name).is_floating_point()]


def with_fields(scene, camera, values):
    """(scene, camera) with ``values``, ``{(group, field): tensor}``, put
    in; the group is ``"camera"`` or one of the scene's."""
    new = {}
    for (g, f), v in values.items():
        new.setdefault(g, {})[f] = v
    camera = dataclasses.replace(camera, **new.pop("camera", {}))
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **fv)
        for g, fv in new.items()}), camera


def _mesh_forward(scene, camera, cfg):
    """The step's image: JAX's branch order (``spira_tpu/render.py``,
    ``_hybrid_mesh_vjp_fn``), its Pallas engines named ``cuda*``."""
    kw = dict(width=cfg["width"], height=cfg["height"], spp=cfg["spp"],
              max_depth=cfg["max_depth"], seed=cfg["seed"],
              inclusive_uv=cfg["inclusive_uv"])
    engine = cfg["engine"]
    if cfg["spectral"]:
        if engine == "cuda_bvh":
            return render_flat_spectral_bvh_megakernel(scene, camera, **kw)
        return render_flat(scene, camera, spectral=True, **kw)
    if engine == "cuda_bvh":
        return render_flat_bvh_megakernel(scene, camera, **kw)
    if engine == "cuda_bvh_mxu":
        return _render_flat_bvh_mxu(scene, camera, **kw)
    return render_flat(scene, camera, **kw)


#: whether the step's replay checkpoints each sample.  It does not: on an
#: NVIDIA H100 (the bunny at 640x360, spp 16, depth 4, grad_spp=2),
#: dropping the checkpoint's recompute took 13-26% off the step for 35 MiB
#: more replay peak (160 in all; spectrally 191 more, 535), the gradients
#: the same bits (``PERF.md``; ``bench/grad_step.py --mesh --designs``)
REPLAY_CHECKPOINT = False


def mesh_replay(scene, camera, *, width: int, height: int, grad_spp: int,
                max_depth: int, seed: int = 0, inclusive_uv: bool = True,
                spectral: bool = False, bwd: str = "packet", query=None):
    """The estimator whose vector-Jacobian product is the backward of
    :func:`render_flat_hybrid_grad_mesh`: the wavefront's mean of
    ``grad_spp`` samples (threefry draws), flat (H*W, 3).  ``bwd``
    ``"packet"`` takes its nearest hits from
    :func:`make_sorted_tile_intersect` with ``grad=True`` (over ``query``,
    :func:`intersect_tile` by default), ``"wavefront"`` from
    ``intersect_scene``."""
    intersect_fn = (make_sorted_tile_intersect(grad=True, query=query)
                    if bwd == "packet" else None)
    return wavefront_mean(scene, camera, intersect_fn, width=width,
                          height=height, spp=grad_spp, max_depth=max_depth,
                          seed=seed, inclusive_uv=inclusive_uv,
                          spectral=spectral,
                          checkpoint_samples=REPLAY_CHECKPOINT)


def mesh_replay_launches(grad_spp: int, max_depth: int) -> int:
    """The nearest-hit calls (#3's launches under ``bwd="packet"``) of a
    backward of :func:`render_flat_hybrid_grad_mesh`: one a bounce of each
    replayed sample (twice, were the samples checkpointed)."""
    return grad_spp * max_depth * (2 if REPLAY_CHECKPOINT else 1)


_REPLAY_KEYS = ("width", "height", "grad_spp", "max_depth", "seed",
                "inclusive_uv", "spectral", "bwd")


class _HybridMeshGrad(torch.autograd.Function):
    """The image of :func:`_mesh_forward`; the backward is the
    vector-Jacobian product of :func:`mesh_replay`, through autograd.
    Inputs: the config, the scene and camera (read for their tables and
    integer fields), then one tensor for each of ``cfg["fields"]``."""

    @staticmethod
    def forward(ctx, cfg, scene, camera, *leaves):
        ctx.cfg, ctx.scene, ctx.camera = cfg, scene, camera
        ctx.save_for_backward(*leaves)
        return _mesh_forward(scene, camera, cfg)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t in inputs if t.requires_grad]
        scene, camera = with_fields(ctx.scene, ctx.camera,
                                    dict(zip(ctx.cfg["fields"], inputs)))
        with torch.enable_grad():
            out = mesh_replay(scene, camera,
                              **{k: ctx.cfg[k] for k in _REPLAY_KEYS})
            grads = (torch.autograd.grad(out, wanted, g, allow_unused=True)
                     if out.requires_grad else [None] * len(wanted))
        grads = iter(grads)
        result = []
        for t, n in zip(inputs, need):
            d = next(grads) if n else None
            result.append(torch.zeros_like(t) if n and d is None else d)
        return (None, None, None, *result)


def render_flat_hybrid_grad_mesh(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    grad_spp: int | None = None,
    inclusive_uv: bool = True,
    engine: str | None = None,
    bwd: str | None = None,
    spectral: bool = False,
):
    """Differentiable mesh render → flat (H*W, 3) bottom-up HDR buffer:
    the counterpart of JAX's ``render_flat_hybrid_grad_mesh``, less its
    TPU knobs.

    Forward (no graph kept): ``engine`` ``"cuda_bvh"`` (the default on a
    scene on the card: kernel #2, with ``spectral`` kernel #5),
    ``"cuda_bvh_mxu"`` (#2 over superleaf blocks, RGB) or ``"wavefront"``
    (:func:`render_flat`; the default off the card), at ``spp``; with
    ``spectral`` every engine but ``cuda_bvh`` renders on the spectral
    wavefront, as JAX's branch order has it.  On the CPU the kernels'
    plain versions run.

    Backward: the wavefront estimator's vector-Jacobian product at
    ``grad_spp`` samples (default ``spp``), replayed under autograd
    (:func:`mesh_replay`; no checkpoint, so each bounce's nearest hit runs
    once).  ``bwd`` is its
    nearest hit: ``"packet"`` (the default on the card) takes
    :func:`make_sorted_tile_intersect` with ``grad=True`` (kernel #3 on
    the card, its plain version on the CPU: a walk without gradient that
    reports the winner's slot, whose triangle's hit is recomputed
    differentiably) and needs ``scene.packed`` with its ``prim_map``;
    ``"wavefront"`` (the default off the card) takes
    :func:`spira_tpu_torch.integrator.intersect.intersect_scene` (the
    stackless walk, which synchronises the host every few steps).
    Gradients reach every float field of the scene's materials (the SPD
    tables too), spheres and triangles, and of the camera; a field the
    replay does not reach gets zeros, the seed none.

    The forward draws PCG4D (the kernels) or threefry (the wavefront), the
    backward threefry: the gradient is an unbiased estimate of the
    expected loss's gradient on an independent stream, not the exact
    gradient of the forward's sample (exact only when the forward is the
    wavefront at ``grad_spp == spp``).
    """
    on_card = scene.device.type == "cuda"
    engine = ("cuda_bvh" if on_card else "wavefront") if engine is None \
        else engine
    bwd = ("packet" if on_card else "wavefront") if bwd is None else bwd
    grad_spp = spp if grad_spp is None else grad_spp
    if engine not in MESH_GRAD_ENGINES:
        raise ValueError(_unknown_engine(engine, MESH_GRAD_ENGINES))
    if bwd not in MESH_GRAD_BWD:
        raise ValueError(f"bwd {bwd!r} is none of {', '.join(MESH_GRAD_BWD)}"
                         " (JAX's 'packet_interpret' is a TPU knob)")
    if bwd == "packet" and (scene.packed is None
                            or scene.packed.prim_map is None):
        raise ValueError("bwd='packet' needs scene.packed with its prim_map "
                         "(spira_tpu_torch.accel.pairs.attach_packed); "
                         "bwd='wavefront' walks scene.bvh")
    if spp < 1 or grad_spp < 1:
        raise ValueError(f"spp and grad_spp must be >= 1, got {spp} and "
                         f"{grad_spp}")
    fields = _float_fields(scene, camera)
    cfg = dict(width=width, height=height, spp=spp, grad_spp=grad_spp,
               max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
               engine=engine, bwd=bwd, spectral=spectral, fields=fields)
    leaves = [getattr(camera if g == "camera" else getattr(scene, g), f)
              for g, f in fields]
    return _HybridMeshGrad.apply(cfg, scene, camera, *leaves)
