"""Progressive chunked rendering with checkpoint/resume, the adaptive
renderer, and ``run_config``, what ``cli render`` runs.

Counterpart of :mod:`spira_tpu.pipeline`.  The host loops over sample
chunks, reports rays/s and an ETA, and saves a checkpoint a chunk, so a
long render survives preemption.  The resume is exact: the RNG is
counter-based, so samples [k, k+n) are the same paths whenever they are
rendered, and each chunk adds its samples to the sum so far in sample
order, so a render in chunks is the one-shot wavefront render to the bit.

With a ``mesh`` (:func:`spira_tpu_torch.parallel.mesh.make_mesh`), or
``n_tile`` in the configuration, each chunk or adaptive round is split
over the ranks' tiles and sample slots (:mod:`spira_tpu_torch.parallel.
sharded`); every rank runs the same host loop, and only the primary rank
writes checkpoints and the image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core import rng as srng
from .io import image as img_io
from .kernels.megakernel import true_divide
from .parallel.distributed import gather_rows, is_primary
from .parallel.mesh import make_mesh, replicate
from .parallel.sharded import (
    accumulate_row_set_sharded,
    render_chunk_sharded,
    render_flat_sharded,
    tile_rows,
)
from .render import (
    accumulate_block_set,
    accumulate_row_set,
    accumulate_rows,
    render_flat_engine,
    wavefront_hook,
)
from .utils import checkpoint as ckpt
from .utils.config import RenderConfig, build_scene, same_render
from .utils.metrics import RenderMeter, logger


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

    With ``mesh`` each chunk is :func:`spira_tpu_torch.parallel.sharded.
    render_chunk_sharded` on the wavefront (chunk sizes divide by the spp
    axis): each rank keeps its tile's sum, adds the chunks' sums to it in
    sample order, as JAX does, and the tiles are gathered for each
    checkpoint, which the primary rank writes, and for the image, which
    every rank returns.
    """
    W, H = cfg.width, cfg.height
    device = camera.origin.device
    n_rows, row_start = (H, 0) if mesh is None else tile_rows(mesh, H)
    tile = slice(row_start * W, (row_start + n_rows) * W)
    acc = torch.zeros((n_rows * W, 3), dtype=torch.float32, device=device)
    done = 0
    if cfg.checkpoint_dir:
        state = ckpt.load_render_state(cfg.checkpoint_dir)
        if state is not None:
            saved_acc, saved_done, saved_seed, saved_cfg = state
            if same_render(saved_cfg, cfg) and saved_seed == cfg.seed:
                acc = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(saved_acc, np.float32)[tile])).to(device)
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
            kw = dict(width=W, height=H, n_samples=take,
                      max_depth=cfg.max_depth, semantics=cfg.semantics,
                      spectral=cfg.spectral, seed=cfg.seed)
            if mesh is None:
                acc = _render_chunk(scene, camera, done,
                                    intersect_fn=intersect_fn, init=acc,
                                    **kw)
            else:
                acc = acc + render_chunk_sharded(scene, camera, done,
                                                 mesh=mesh, **kw)
            done += take
            # the previous chunk's save goes only now, behind this chunk's
            # launch, so its write overlaps this chunk's work
            if pending_save is not None:
                saver.submit(ckpt.save_render_state, cfg.checkpoint_dir,
                             **pending_save)
                pending_save = None
            if cfg.checkpoint_dir and done < cfg.spp:
                snapshot = (ckpt.host_snapshot(acc) if mesh is None
                            else gather_rows(acc, mesh))
                if is_primary():
                    pending_save = dict(accumulator=snapshot,
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
    if mesh is not None:
        flat = gather_rows(flat, mesh)
    return img_io.assemble_image(flat, W, H).cpu().numpy()


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
    two so that it compiles few programs; nothing is compiled here, so on
    one device no segment is padded, and a ray's draws depend only on its
    position, so the live segments' samples are the same.

    With ``mesh`` (rows only, as in JAX) each round's row set is padded
    as JAX pads it, to ``n_tile`` times a power of two (never past the
    image) with copies of its first row, split contiguously over the
    tiles, whose keys fold in the tile index, and its samples over the
    spp axis (:func:`spira_tpu_torch.parallel.sharded.
    accumulate_row_set_sharded`; ``chunk`` is rounded up to the axis):
    the padding decides which rows draw which stream, so it draws JAX's
    bits.  The round's sums are gathered to every rank's host, every
    rank keeps the same ledger, the pad rows' sums are dropped, and only
    the primary rank writes checkpoints.

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
    also a dict of sample counts (``dispatched_samples`` counts the pad
    rows too), the per-segment spp map, the rounds and the host syncs.
    """
    W, H = cfg.width, cfg.height
    max_spp = cfg.spp
    if max_spp < 1:
        raise ValueError(f"spp must be >= 1, got {max_spp}")
    min_spp = min(min_spp, max_spp)
    base = srng.base_key(cfg.seed)

    if granularity == "block":
        if mesh is not None:
            raise NotImplementedError(
                "block-granularity adaptive sampling is single-device; "
                "use granularity='row' with a mesh")
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

    n_tile, n_spp = (1, 1) if mesh is None else (mesh.n_tile, mesh.n_spp)
    if max_spp % n_spp:
        raise ValueError(f"spp {max_spp} must divide by the spp axis "
                         f"{n_spp}")
    chunk = -(-chunk // n_spp) * n_spp  # rounded up to the axis

    active = np.arange(n_segs, dtype=np.int32)
    spp_done = 0  # active segments retire together, so they share a count
    sample_base = 0

    # the stopping hyperparameters and the mesh shape live in the manifest
    # beside the config: a resumed run must take the same retirement
    # decisions and draw the same streams (the tiles fold their index into
    # the keys, so another mesh draws others)
    hyper = dict(tol=tol, min_spp=min_spp, chunk=chunk, quantile=quantile,
                 mesh=[n_tile, n_spp], granularity=granularity,
                 statistic=statistic)
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

    if mesh is not None:
        set_fn = functools.partial(accumulate_row_set_sharded, mesh=mesh)
    elif granularity == "block":
        set_fn = accumulate_block_set
    else:
        set_fn = accumulate_row_set
    device = camera.origin.device
    rounds = dispatched = 0
    while active.size and spp_done < max_spp:
        take = int(min(chunk, max_spp - spp_done))
        r = active.size
        # under a mesh, JAX's padding: n_tile times a power of two, never
        # past the whole image
        r_pad = r if mesh is None else min(
            n_tile * (1 << (-(-r // n_tile) - 1).bit_length()),
            n_tile * -(-n_segs // n_tile))
        dispatched += r_pad * take
        segs = np.concatenate([active, np.full(r_pad - r, active[0],
                                               np.int32)])
        # the set goes up without waiting for the card (the array is
        # staged before the call returns and never written again)
        ids = torch.from_numpy(segs).to(device, non_blocking=True)
        a, l, l2 = set_fn(
            scene, camera, base, ids, sample_base, width=W, height=H,
            n_samples=take,
            max_depth=cfg.max_depth, semantics=cfg.semantics,
            spectral=cfg.spectral, intersect_fn=intersect_fn)
        # the round's sums to the host in one copy (under a mesh, one
        # gather of the tiles): the loop's one sync
        sums = torch.cat([a, l[:, None], l2[:, None]], 1)
        host = (sums.cpu() if mesh is None
                else gather_rows(sums, mesh)).numpy()[:r * seg_w]
        at = seg_index(active)
        acc[at] += host[:, :3].reshape(r, seg_w, 3)
        lum[at] += host[:, 3].reshape(r, seg_w)
        lum2[at] += host[:, 4].reshape(r, seg_w)
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

        if (cfg.checkpoint_dir and active.size and spp_done < max_spp
                and is_primary()):
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
        "dispatched_samples": dispatched * seg_w,
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
    then the adaptive renderer (``cfg.adaptive_tol``, whole rows under a
    mesh), then the progressive renderer (a checkpoint directory or
    interval), then the sharded wavefront frame
    (:func:`spira_tpu_torch.parallel.sharded.render_flat_sharded`), else
    one render through the engine dispatch (``render_flat_engine``, so
    the kernels serve the scenes they serve in ``render``).

    ``cfg.n_tile`` puts the adaptive, progressive or one-shot render on a
    (``n_tile``, ``n_spp_axis``) mesh over the ranks of the default
    process group (:func:`spira_tpu_torch.parallel.mesh.make_mesh` on the
    scene's device; the scene and camera replicated from rank 0), as
    JAX's ``run_config`` does, ``--engine`` ignored; every rank renders
    and returns the whole image, and only the primary rank writes it."""
    scene, camera = build_scene(cfg)
    if cfg.shading != "full":
        from .integrator.preview import render_flat_preview

        flat = render_flat_preview(scene, camera, width=cfg.width,
                                   height=cfg.height, seed=cfg.seed,
                                   shading=cfg.shading)
        out = _tonemap(cfg, img_io.assemble_image(flat, cfg.width,
                                                  cfg.height))
        if cfg.output and is_primary():
            img_io.save_png(cfg.output, out)
            logger.info("wrote %s", cfg.output)
        return out

    if cfg.engine != "auto" and (
            cfg.n_tile is not None or cfg.checkpoint_dir
            or cfg.checkpoint_every > 0 or cfg.adaptive_tol is not None):
        logger.warning(
            "--engine %s is ignored by the sharded, progressive and adaptive "
            "renderers (wavefront family only: they need sample offsets)",
            cfg.engine)
    mesh = None
    if cfg.n_tile is not None:
        mesh = make_mesh(n_tile=cfg.n_tile, n_spp=cfg.n_spp_axis,
                         device=scene.device)
        scene, camera = replicate(scene, mesh), replicate(camera, mesh)
    if cfg.adaptive_tol is not None:
        gran = cfg.adaptive_granularity
        if mesh is not None or cfg.width % 128:
            # block sets are single-device and need the width in 128-pixel
            # blocks
            gran = "row"
        hdr, stats = render_adaptive(
            scene, camera, cfg, tol=cfg.adaptive_tol,
            min_spp=cfg.adaptive_min_spp, return_stats=True,
            granularity=gran, mesh=mesh)
        logger.info(
            "adaptive: %.0f%% of uniform %d spp (%d samples saved), %d "
            "rounds, %d host syncs",
            100.0 * (1.0 - stats["savings"]), cfg.spp,
            stats["uniform_samples"] - stats["total_samples"],
            stats["rounds"], stats["host_syncs"],
            extra={"adaptive_stats": stats})
    elif cfg.checkpoint_dir or cfg.checkpoint_every > 0:
        # under a mesh the BASELINE config-5 shape: chunked, checkpointed,
        # each chunk sharded
        hdr = render_progressive(scene, camera, cfg, mesh=mesh)
    elif mesh is not None:
        flat = render_flat_sharded(
            scene, camera, width=cfg.width, height=cfg.height, mesh=mesh,
            spp=cfg.spp, max_depth=cfg.max_depth, seed=cfg.seed,
            semantics=cfg.semantics, spectral=cfg.spectral)
        hdr = img_io.assemble_image(gather_rows(flat, mesh), cfg.width,
                                    cfg.height)
    else:
        flat = render_flat_engine(
            scene, camera, width=cfg.width, height=cfg.height, spp=cfg.spp,
            max_depth=cfg.max_depth, seed=cfg.seed, semantics=cfg.semantics,
            spectral=cfg.spectral, engine=cfg.engine)
        hdr = img_io.assemble_image(flat, cfg.width, cfg.height)

    out = _tonemap(cfg, hdr)
    if cfg.output and is_primary():
        if cfg.output.endswith(".exr"):
            img_io.save_exr(cfg.output, hdr)
        elif cfg.output.endswith(".ppm"):
            img_io.save_ppm(cfg.output, out)
        else:
            img_io.save_png(cfg.output, out)
        logger.info("wrote %s", cfg.output)
    return out
