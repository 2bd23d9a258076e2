"""Progressive chunked rendering with checkpoint/resume, the adaptive
renderer, and ``run_config``, what ``cli render`` runs.

Counterpart of :mod:`spira_tpu.pipeline`, on one device.  The host loops
over sample chunks, reports rays/s and an ETA, and saves a checkpoint a
chunk, so a long render survives preemption.  The resume is exact: the
RNG is counter-based, so samples [k, k+n) are the same paths whenever
they are rendered, and each chunk adds its samples to the sum so far in
sample order, so a render in chunks is the one-shot wavefront render to
the bit.

The sharded paths (``n_tile``, a device ``mesh``) raise
``NotImplementedError`` naming ROADMAP item 16.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import rng as srng
from .io import image as img_io
from .kernels.megakernel import true_divide
from .render import (
    _not_ported,
    accumulate_block_set,
    accumulate_row_set,
    accumulate_rows,
    render_flat_engine,
    wavefront_hook,
)
from .utils import checkpoint as ckpt
from .utils.config import RenderConfig, build_scene, same_render
from .utils.metrics import RenderMeter, logger


def _sharded(what: str):
    return _not_ported(what, "item 16, parallel/")


def _render_chunk(scene, camera, sample_offset, *, width, height, n_samples,
                  max_depth, semantics, spectral, seed, inclusive_uv=True,
                  intersect_fn=None, init=None):
    """The sum of ``n_samples`` samples from ``sample_offset`` on, added to
    ``init`` (the sum so far; zeros when ``None``): the wavefront's
    :func:`spira_tpu_torch.render.accumulate_rows` over the whole
    frame."""
    return accumulate_rows(
        scene, camera, srng.base_key(seed), width=width, height=height,
        row_start=0, n_rows=height, sample_offset=sample_offset,
        n_samples=n_samples, max_depth=max_depth, semantics=semantics,
        inclusive_uv=inclusive_uv, spectral=spectral,
        intersect_fn=intersect_fn, init=init)


def render_progressive(scene, camera, cfg: RenderConfig,
                       mesh=None) -> np.ndarray:
    """Render under ``cfg`` in chunks of ``cfg.checkpoint_every`` samples
    (all of ``cfg.spp`` at once when it is 0), with progress reporting and,
    with ``cfg.checkpoint_dir``, a checkpoint a chunk; returns the (H, W,
    3) HDR image as NumPy.

    A checkpoint whose config (every field but ``device``) and seed match
    is resumed, one written by the JAX package included; another one is
    ignored and the render starts afresh.  Each chunk's save is taken as a
    host copy behind the chunk (:func:`ckpt.host_snapshot`) and written on
    a thread after the next chunk's launch, so the write overlaps the
    render.  A chunk that raises still writes the last completed chunk's
    checkpoint before the error leaves.  With ``cfg.progress`` the meter
    synchronises the card once a chunk.  On a packed scene on the card the
    nearest hits come from kernel #3
    (:func:`spira_tpu_torch.render.wavefront_hook`), as in
    ``render_flat``.
    """
    if mesh is not None:
        raise _sharded("the sharded progressive renderer (mesh=)")
    device = camera.origin.device
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                      device=device)
    done = 0
    if cfg.checkpoint_dir:
        state = ckpt.load_render_state(cfg.checkpoint_dir)
        if state is not None:
            saved_acc, saved_done, saved_seed, saved_cfg = state
            if same_render(saved_cfg, cfg) and saved_seed == cfg.seed:
                acc = torch.from_numpy(
                    np.asarray(saved_acc, np.float32)).to(device)
                done = saved_done
                logger.info("resumed at sample %d/%d", done, cfg.spp,
                            extra={"resumed_samples": done})
            else:
                logger.warning("checkpoint config mismatch — starting fresh")

    chunk = cfg.checkpoint_every if cfg.checkpoint_every > 0 else cfg.spp
    meter = RenderMeter(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                        enabled=cfg.progress)
    meter.samples_done = done
    intersect_fn = wavefront_hook(scene, cfg.semantics)
    saver = ckpt.AsyncSaver()
    pending_save = None
    try:
        while done < cfg.spp:
            take = min(chunk, cfg.spp - done)
            acc = _render_chunk(
                scene, camera, done, width=cfg.width, height=cfg.height,
                n_samples=take, max_depth=cfg.max_depth,
                semantics=cfg.semantics, spectral=cfg.spectral,
                seed=cfg.seed, intersect_fn=intersect_fn, init=acc)
            done += take
            # the previous chunk's save goes only now, behind this chunk's
            # launch, so its write overlaps this chunk's work
            if pending_save is not None:
                saver.submit(ckpt.save_render_state, cfg.checkpoint_dir,
                             **pending_save)
                pending_save = None
            if cfg.checkpoint_dir and done < cfg.spp:
                pending_save = dict(accumulator=ckpt.host_snapshot(acc),
                                    samples_done=done, seed=cfg.seed,
                                    config_json=cfg.to_json())
            meter.update(done)
    finally:
        # a chunk that raised: keep the last completed chunk's checkpoint
        if pending_save is not None:
            saver.submit(ckpt.save_render_state, cfg.checkpoint_dir,
                         **pending_save)
        saver.wait()
    flat = true_divide(acc, float(cfg.spp))
    return img_io.assemble_image(flat, cfg.width, cfg.height).cpu().numpy()


def render_adaptive(
    scene,
    camera,
    cfg: RenderConfig,
    *,
    tol: float = 0.02,
    min_spp: int = 8,
    chunk: int = 8,
    quantile: float = 0.98,
    return_stats: bool = False,
    intersect_fn="auto",
    mesh=None,
    granularity: str = "row",
    statistic: str = "auto",
):
    """Variance-guided progressive render: segments (whole rows, or
    128-pixel row blocks) stop sampling once their luminance confidence
    intervals converge.

    Each round dispatches one wavefront over only the segments whose error
    is still above ``tol`` (:func:`spira_tpu_torch.render.
    accumulate_row_set` / ``accumulate_block_set``), then reads the
    round's sums on the host, where the convergence ledger lives: one copy
    from the card a round, the design's only synchronisation (counted in
    the stats as ``host_syncs``).  JAX pads each round's set to a power of
    two so that it compiles few programs; nothing is compiled here, so no
    segment is padded, and a ray's draws depend only on its position, so
    the live segments' samples are the same.

    Convergence, as in JAX: ``statistic="quantile"`` retires a segment
    when the ``quantile`` of its pixels' relative half-CI95 of mean
    luminance drops to ``tol``; ``"mean"`` when the relative half-CI95 of
    the segment's MEAN luminance does; ``"auto"`` takes ``"mean"`` for
    blocks and ``"quantile"`` for rows.  ``cfg.spp`` is the per-segment
    sample cap, ``min_spp`` the floor before any segment may retire.

    ``intersect_fn="auto"`` takes kernel #3 on a packed scene on the card
    (:func:`spira_tpu_torch.render.wavefront_hook`; JAX takes its Pallas
    hook on the TPU), else ``intersect_scene``.  With
    ``cfg.checkpoint_dir`` each round saves the whole ledger, and a run
    with the same config and hyperparameters resumes from it exactly.

    Returns the (H, W, 3) HDR image as NumPy; with ``return_stats=True``
    also a dict of sample counts, the per-segment spp map, the rounds and
    the host syncs.
    """
    if mesh is not None:
        raise _sharded("the sharded adaptive renderer (mesh=)")
    W, H = cfg.width, cfg.height
    max_spp = cfg.spp
    if max_spp < 1:
        raise ValueError(f"spp must be >= 1, got {max_spp}")
    min_spp = min(min_spp, max_spp)
    base = srng.base_key(cfg.seed)

    if granularity == "block":
        if W % 128:
            raise ValueError(f"granularity='block' needs W % 128 == 0, "
                             f"got {W}")
        nbx, seg_w = W // 128, 128
    elif granularity == "row":
        nbx, seg_w = 1, W
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    if statistic == "auto":
        statistic = "mean" if granularity == "block" else "quantile"
    if statistic not in ("mean", "quantile"):
        raise ValueError(f"unknown statistic {statistic!r}")
    n_segs = H * nbx
    lane = np.arange(seg_w)

    def seg_index(segs):
        """Index of a per-pixel (H, W[, C]) ledger array by segment."""
        if granularity == "row":
            return segs
        return ((segs // nbx)[:, None],
                (segs % nbx)[:, None] * seg_w + lane[None, :])

    if intersect_fn == "auto":
        intersect_fn = wavefront_hook(scene, cfg.semantics)

    acc = np.zeros((H, W, 3), np.float32)
    lum = np.zeros((H, W), np.float64)
    lum2 = np.zeros((H, W), np.float64)
    counts = np.zeros((n_segs,), np.int64)
    meter = RenderMeter(W, H, max_spp, cfg.max_depth, enabled=cfg.progress)

    active = np.arange(n_segs, dtype=np.int32)
    spp_done = 0  # active segments retire together, so they share a count
    sample_base = 0

    # the stopping hyperparameters live in the manifest beside the config:
    # a resumed run must take the same retirement decisions (the mesh
    # shape stays in the layout JAX writes, here always one device)
    hyper = dict(tol=tol, min_spp=min_spp, chunk=chunk, quantile=quantile,
                 mesh=[1, 1], granularity=granularity, statistic=statistic)
    if cfg.checkpoint_dir:
        state = ckpt.load_adaptive_state(cfg.checkpoint_dir)
        if state is not None:
            arrays, scalars, saved_cfg = state
            if (same_render(saved_cfg, cfg)
                    and {k: scalars.get(k) for k in hyper} == hyper):
                acc, lum, lum2 = arrays["acc"], arrays["lum"], arrays["lum2"]
                counts, active = arrays["counts"], arrays["active"]
                spp_done = scalars["spp_done"]
                sample_base = scalars["sample_base"]
                logger.info("resumed adaptive at %d active segments, %d spp",
                            active.size, spp_done)
            else:
                logger.warning("checkpoint config mismatch — starting fresh")
    meter.samples_done = int(counts.sum() / n_segs)

    set_fn = accumulate_block_set if granularity == "block" \
        else accumulate_row_set
    device = camera.origin.device
    rounds = 0
    while active.size and spp_done < max_spp:
        take = int(min(chunk, max_spp - spp_done))
        r = active.size
        # the set goes up without waiting for the card (the array is
        # staged before the call returns and never written again)
        ids = torch.from_numpy(active).to(device, non_blocking=True)
        a, l, l2 = set_fn(
            scene, camera, base, ids, sample_base, width=W, height=H,
            n_samples=take,
            max_depth=cfg.max_depth, semantics=cfg.semantics,
            spectral=cfg.spectral, intersect_fn=intersect_fn)
        # the round's sums to the host in one copy: the loop's one sync
        host = torch.cat([a.reshape(-1), l, l2]).cpu().numpy()
        n = r * seg_w
        at = seg_index(active)
        acc[at] += host[:3 * n].reshape(r, seg_w, 3)
        lum[at] += host[3 * n:4 * n].reshape(r, seg_w)
        lum2[at] += host[4 * n:].reshape(r, seg_w)
        counts[active] += take
        spp_done += take
        sample_base += take
        rounds += 1
        meter.update(int(counts.sum() / n_segs))

        if spp_done >= min_spp and spp_done > 1:
            n_s = float(spp_done)
            mean = lum[at] / n_s
            var = np.maximum(lum2[at] / n_s - mean * mean, 0.0)
            var *= n_s / (n_s - 1.0)
            if statistic == "mean":
                # relative half-CI95 of the segment's MEAN luminance:
                # Var(mean of seg_w pixel means) = sum(var_i) / seg_w^2 / n
                m_seg = mean.mean(axis=1)
                se = np.sqrt(var.sum(axis=1) / n_s) / seg_w
                seg_err = 1.96 * se / (np.abs(m_seg) + 1e-3)
            else:
                rel_ci = 1.96 * np.sqrt(var / n_s) / (np.abs(mean) + 1e-3)
                seg_err = np.quantile(rel_ci, quantile, axis=1)
            active = active[seg_err > tol]

        if cfg.checkpoint_dir and active.size and spp_done < max_spp:
            ckpt.save_adaptive_state(
                cfg.checkpoint_dir,
                arrays=dict(acc=acc, lum=lum, lum2=lum2, counts=counts,
                            active=active),
                scalars=dict(spp_done=int(spp_done),
                             sample_base=int(sample_base), **hyper),
                config_json=cfg.to_json(),
            )

    # per-pixel spp: the per-segment count over its pixels
    pix_counts = np.repeat(counts.reshape(H, nbx), seg_w, axis=1)
    img = acc / pix_counts[:, :, None].astype(np.float32)
    img = img[::-1]  # bottom-up rows -> top-down image
    if not return_stats:
        return img
    spp_map = counts.reshape(H, nbx)[::-1]  # top-down, like the image
    total = int(counts.sum()) * seg_w
    uniform = H * W * max_spp
    stats = {
        "total_samples": total,
        "uniform_samples": uniform,
        "savings": 1.0 - total / float(uniform),
        "spp_per_row": spp_map.mean(axis=1),
        "spp_map": spp_map,  # (H, W/seg_w) per-segment counts
        "granularity": granularity,
        "tol": tol,
        "rounds": rounds,
        "host_syncs": rounds,
    }
    return img, stats


def _tonemap(cfg: RenderConfig, hdr) -> np.ndarray:
    if not torch.is_tensor(hdr):
        hdr = torch.from_numpy(np.ascontiguousarray(hdr))
    return img_io.to_uint8(img_io.TONEMAPS[cfg.tonemap](hdr))


def run_config(cfg: RenderConfig) -> np.ndarray:
    """Build the scene, render, tone map and save: the (H, W, 3) uint8
    image.  The dispatch follows JAX's order: a preview shading first,
    then the adaptive renderer (``cfg.adaptive_tol``), then the sharded
    renderers (``cfg.n_tile``: not ported, ROADMAP item 16), then the
    progressive renderer (a checkpoint directory or interval), else one
    render through the engine dispatch (``render_flat_engine``, so the
    kernels serve the scenes they serve in ``render``)."""
    scene, camera = build_scene(cfg)
    if cfg.shading != "full":
        from .integrator.preview import render_flat_preview

        flat = render_flat_preview(scene, camera, width=cfg.width,
                                   height=cfg.height, seed=cfg.seed,
                                   shading=cfg.shading)
        out = _tonemap(cfg, img_io.assemble_image(flat, cfg.width,
                                                  cfg.height))
        if cfg.output:
            img_io.save_png(cfg.output, out)
            logger.info("wrote %s", cfg.output)
        return out

    if cfg.engine != "auto" and (
            cfg.n_tile is not None or cfg.checkpoint_dir
            or cfg.checkpoint_every > 0 or cfg.adaptive_tol is not None):
        logger.warning(
            "--engine %s is ignored by the progressive and adaptive renderers "
            "(wavefront family only: they need sample offsets)", cfg.engine)
    if cfg.n_tile is not None:
        raise _sharded("n_tile (the tile-sharded renderers)")
    if cfg.adaptive_tol is not None:
        gran = cfg.adaptive_granularity
        if cfg.width % 128:
            gran = "row"  # block sets need the width in 128-pixel blocks
        hdr, stats = render_adaptive(
            scene, camera, cfg, tol=cfg.adaptive_tol,
            min_spp=cfg.adaptive_min_spp, return_stats=True,
            granularity=gran)
        logger.info(
            "adaptive: %.0f%% of uniform %d spp (%d samples saved), %d "
            "rounds, %d host syncs",
            100.0 * (1.0 - stats["savings"]), cfg.spp,
            stats["uniform_samples"] - stats["total_samples"],
            stats["rounds"], stats["host_syncs"],
            extra={"adaptive_stats": stats})
    elif cfg.checkpoint_dir or cfg.checkpoint_every > 0:
        hdr = render_progressive(scene, camera, cfg)
    else:
        flat = render_flat_engine(
            scene, camera, width=cfg.width, height=cfg.height, spp=cfg.spp,
            max_depth=cfg.max_depth, seed=cfg.seed, semantics=cfg.semantics,
            spectral=cfg.spectral, engine=cfg.engine)
        hdr = img_io.assemble_image(flat, cfg.width, cfg.height)

    out = _tonemap(cfg, hdr)
    if cfg.output:
        if cfg.output.endswith(".exr"):
            img_io.save_exr(cfg.output, hdr)
        elif cfg.output.endswith(".ppm"):
            img_io.save_ppm(cfg.output, out)
        else:
            img_io.save_png(cfg.output, out)
        logger.info("wrote %s", cfg.output)
    return out
