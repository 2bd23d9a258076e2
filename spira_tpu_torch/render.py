"""Top-level render entry points: engine choice, HDR render, tone-mapped
image.

Counterpart of the entry points of :mod:`spira_tpu.render` for the slices
the port has: sphere and small-triangle scenes (at most
``FUSED_TRI_LIMIT`` triangles, no BVH) and mesh scenes with packed BVH
tables, physical semantics, RGB or spectral, full shading.  The engines
are

* ``cuda``     — the hand-written CUDA megakernel (with ``spectral=True``,
  the spectral megakernel), for scenes on a CUDA device (the plain tracer
  for scenes on the CPU);
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
* ``fused``    — the plain PyTorch tracer (RGB or spectral), on any device.

``engine="auto"`` never picks the two superleaf engines, as in JAX: they
are the retired experiments of :mod:`spira_tpu_torch.experiments`.

Every other path of the JAX renderer raises ``NotImplementedError`` naming
the ROADMAP item (queue 1) that brings it.
"""

from __future__ import annotations

import numpy as np

from .accel.mxu import MXUBVH, SuperleafBVH, attach_mxu, attach_superleaf
from .io import image as img_io
from .kernels.bvh_megakernel import render_flat_bvh_megakernel
from .kernels.megakernel import (
    FUSED_TRI_LIMIT,
    render_flat_fused,
    render_flat_megakernel,
)
from .kernels.mxu_megakernel import render_flat_mxu_megakernel
from .kernels.spectral_bvh import render_flat_spectral_bvh_megakernel
from .kernels.spectral_fused import (
    render_flat_fused_spectral,
    render_flat_spectral_megakernel,
)


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
           "cuda_bvh_mxu", "fused")
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
    """Resolve the execution engine: for a scene with packed BVH tables on
    a CUDA device ``cuda_bvh`` (``cuda_spectral_bvh`` with ``spectral``),
    ``cuda`` for a small scene on a CUDA device, ``fused`` for one on the
    CPU, or the engine named.  A BVH scene on the CPU goes to the wavefront
    estimator in the JAX package (its spectral variant too), which is not
    ported yet."""
    if semantics != "physical":
        raise _not_ported(
            f"semantics={semantics!r}" + (" with spectral=True" if spectral
                                          else ""),
            "item 10, the wavefront estimator",
        )
    if engine == "auto":
        if scene.packed is not None and scene.device.type == "cuda":
            return "cuda_spectral_bvh" if spectral else "cuda_bvh"
        for table in ("packed", "bvh"):
            if getattr(scene, table, None) is not None:
                bvh_engine = "cuda_spectral_bvh" if spectral else "cuda_bvh"
                raise _not_ported(
                    f"a scene with a {table!r} table on "
                    f"{scene.device.type} under engine='auto' (the BVH "
                    "kernel takes packed scenes on cuda; "
                    f"engine={bvh_engine!r} runs its plain version here)",
                    "item 10, the wavefront estimator",
                )
        if not (
            scene.triangles.count <= FUSED_TRI_LIMIT
            and (scene.spheres.count + scene.triangles.count) > 0
        ):
            raise _not_ported(
                f"a scene with {scene.triangles.count} triangles and no BVH "
                f"(the fused engines take at most {FUSED_TRI_LIMIT}; a mesh "
                "scene with a BVH and attach_packed renders on cuda_bvh)",
                "item 10, the wavefront estimator",
            )
        return "cuda" if scene.device.type == "cuda" else "fused"
    if engine not in ENGINES:
        raise _not_ported(
            f"engine {engine!r} (the port has {', '.join(ENGINES)})",
            "items 10-13",
        )
    return engine


def render_flat_engine(
    scene, camera, *, width, height, spp=16, max_depth=4, seed=0,
    semantics="physical", inclusive_uv=True, spectral=False, engine="auto",
):
    """Flat (H*W, 3) bottom-up HDR render with engine dispatch: linear
    RGB, or with ``spectral`` linear sRGB from the spectral XYZ film."""
    engine = select_engine(scene, semantics, spectral, engine, camera=camera)
    fn = _ENGINE_FNS[engine][bool(spectral)]
    if fn is None:
        raise ValueError(
            f"engine {engine!r} renders RGB only; use "
            "engine='cuda_spectral_bvh' (or 'auto') for spectral mesh scenes"
        )
    return fn(
        scene, camera, width=width, height=height, spp=spp,
        max_depth=max_depth, seed=seed, inclusive_uv=inclusive_uv,
    )


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
