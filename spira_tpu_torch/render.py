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
  :mod:`spira_tpu_torch.accel.traverse` or brute force.

Every engine but ``wavefront`` renders physical semantics only.
``engine="auto"`` never picks the two superleaf engines, as in JAX: they
are the retired experiments of :mod:`spira_tpu_torch.experiments`.

Every other path of the JAX renderer raises ``NotImplementedError`` naming
the ROADMAP item (queue 1) that brings it.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.mxu import MXUBVH, SuperleafBVH, attach_mxu, attach_superleaf
from .core import rng as srng
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
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    intersect_fn = None
    if (scene.packed is not None and semantics == "physical"
            and scene.device.type == "cuda"):
        intersect_fn = make_sorted_tile_intersect(grad=grad_hook)
    acc = accumulate_rows(
        scene, camera, srng.base_key(seed), width=width, height=height,
        row_start=0, n_rows=height, sample_offset=0, n_samples=spp,
        max_depth=max_depth, semantics=semantics, inclusive_uv=inclusive_uv,
        spectral=spectral, intersect_fn=intersect_fn)
    return true_divide(acc, float(spp))


def accumulate_rows(scene, camera, base_key, *, width: int, height: int,
                    row_start: int, n_rows: int, sample_offset: int,
                    n_samples: int, max_depth: int, semantics: str,
                    inclusive_uv: bool = True, spectral: bool = False,
                    intersect_fn=None):
    """The sum of ``n_samples`` radiance estimates for the rows
    ``row_start .. row_start + n_rows``: (n_rows*width, 3).  Sample ``k``
    draws from ``fold_in(sample_key(base_key, sample_offset + k),
    row_start)``, so tiles of one image draw decorrelated randomness;
    callers divide by the total spp."""
    acc = torch.zeros((n_rows * width, 3), dtype=torch.float32,
                      device=camera.origin.device)
    for k in range(n_samples):
        skey = srng.fold_in(srng.sample_key(base_key, sample_offset + k),
                            row_start)
        origins, dirs = generate_rays(camera, width, height, skey,
                                      inclusive_uv=inclusive_uv,
                                      row_start=row_start, n_rows=n_rows)
        if spectral:
            radiance = trace_spectral(scene, origins, dirs, skey,
                                      max_depth=max_depth,
                                      intersect_fn=intersect_fn)
        else:
            radiance = trace(scene, origins, dirs, skey, max_depth=max_depth,
                             semantics=semantics, intersect_fn=intersect_fn)
        acc = acc + radiance
    return acc


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
           "cuda_bvh_mxu", "fused", "wavefront")
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
            raise _not_ported(
                f"engine {engine!r} (the port has {', '.join(ENGINES)})",
                "items 11-13")
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

    ``output_path`` ending in ``.exr`` saves the HDR image, ``.ppm`` a PPM,
    anything else a PNG.
    """
    if shading != "full":
        raise _not_ported(
            f"shading={shading!r}", "item 13, the preview renderers"
        )
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
