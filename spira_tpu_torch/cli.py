"""Command-line interface.

Counterpart of :mod:`spira_tpu.cli`::

    python -m spira_tpu_torch.cli render --scene cornell --spectral -o out.png
    python -m spira_tpu_torch.cli inverse --steps 200 -o recovered.png
    python -m spira_tpu_torch.cli info

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given; asking for the card on a host without one
raises, and nothing falls back to the CPU.

``render --n-tile N [--n-spp-axis M]`` renders over a (N, M) mesh of the
``torch.distributed`` ranks; run it under ``torchrun`` (one process a
rank, each on card ``LOCAL_RANK``), and only rank 0 writes the image::

    torchrun --nproc-per-node 2 -m spira_tpu_torch.cli render --n-tile 2
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys


def _cmd_render(args) -> int:
    from .parallel.distributed import initialize
    from .pipeline import run_config
    from .utils.config import config_from_args
    from .utils.metrics import Timer, logger

    cfg = config_from_args(args)
    initialize(device=cfg.device)  # a no-op unless run under torchrun
    with Timer("render") as t:  # synchronises the card on both ends
        run_config(cfg)
    rays = cfg.width * cfg.height * cfg.spp * cfg.max_depth
    logger.info(
        "%.2f Mrays/s (%d rays in %.2fs)", rays / t.elapsed / 1e6, rays,
        t.elapsed, extra={"render_seconds": t.elapsed},
    )
    return 0


def _cmd_inverse(args) -> int:
    import numpy as np
    import torch

    from .diff.inverse import make_inverse_step
    from .io import image as img_io
    from .render import render_flat, with_fields
    from .utils import checkpoint as ckpt
    from .utils.config import build_scene, config_from_args
    from .utils.metrics import Timer, logger

    cfg = config_from_args(args)
    scene, camera = build_scene(cfg)
    device = scene.device

    if args.target:
        # EXRs are stored top-down; the loss compares bottom-up flat
        # buffers (undo the assembly's flip)
        target_img = img_io.load_exr(args.target)
        target = torch.from_numpy(np.ascontiguousarray(
            np.asarray(target_img, np.float32)[::-1].reshape(-1, 3))).to(
                device)
    else:
        logger.info("no --target: synthesizing one from the true scene")
        target = render_flat(
            scene, camera, width=cfg.width, height=cfg.height, spp=cfg.spp,
            max_depth=cfg.max_depth, seed=cfg.seed + 1,
            spectral=cfg.spectral,
        )

    # a packed scene on the card takes #3's differentiable hook, as
    # render_flat takes #3 there
    packet = scene.packed is not None and device.type == "cuda"
    step, init = make_inverse_step(
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_depth=cfg.max_depth, spectral=cfg.spectral,
        learning_rate=args.lr, intersect="packet" if packet else None,
    )
    key = "albedo_spd" if cfg.spectral else "albedo"
    table = getattr(scene.materials, key)
    params = {key: torch.full_like(table, 0.5),
              "emission": torch.ones_like(scene.materials.emission)}
    opt_state = init(params)
    start = 0
    if cfg.checkpoint_dir:
        restored = ckpt.load_train_state(cfg.checkpoint_dir, params,
                                         opt_state)
        if restored is not None:
            params, opt_state, start = restored
            logger.info("resumed inverse loop at step %d", start)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loss = None
    with Timer() as t:
        for it in range(start, args.steps):
            params, opt_state, loss = step(
                params, opt_state, scene, camera, target, it)
            if it % max(1, args.steps // 20) == 0:
                value = float(loss)  # the logged loss: a host sync
                logger.info("step %d  loss %.6f", it, value,
                            extra={"step": it, "loss": value})
            if cfg.checkpoint_dir and cfg.checkpoint_every and (
                    (it + 1) % cfg.checkpoint_every == 0):
                ckpt.save_train_state(cfg.checkpoint_dir, params=params,
                                      opt_state=opt_state, step=it + 1)
    n_steps = args.steps - start
    peak = (torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else None)
    logger.info(
        "inverse: %d steps in %.3f s (%.1f ms a step), peak memory %s",
        n_steps, t.elapsed, 1e3 * t.elapsed / max(n_steps, 1),
        "not measured (CPU)" if peak is None else f"{peak:.1f} MiB",
        extra={"inverse_stats": dict(steps=n_steps, seconds=t.elapsed,
                                     peak_mib=peak)})
    if loss is not None:
        logger.info("final loss %.6f", float(loss))
    if cfg.output:
        recovered, _ = with_fields(
            scene, camera,
            {("materials", k): v.detach() for k, v in params.items()})
        flat = render_flat(
            recovered, camera, width=cfg.width, height=cfg.height,
            spp=max(cfg.spp, 16), max_depth=cfg.max_depth,
            spectral=cfg.spectral,
        )
        hdr = img_io.assemble_image(flat, cfg.width, cfg.height)
        img_io.save_png(cfg.output,
                        img_io.to_uint8(img_io.tonemap_gamma(hdr)))
        logger.info("wrote %s", cfg.output)
    return 0


def _power_limits() -> list:
    """``name, power.limit`` of each card as ``nvidia-smi`` reads them,
    one string a card; empty without ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _cmd_info(args) -> int:
    import torch

    print("spira_tpu_torch — the PyTorch/CUDA port of spira_tpu, a "
          "differentiable spectral path tracer")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("cards: none (torch.cuda.is_available() is False); run with "
              "--device cpu")
        return 0
    limits = _power_limits()
    print(f"cards: {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        limit = limits[i] if i < len(limits) else "power limit not read"
        print(f"  cuda:{i}: {torch.cuda.get_device_name(i)} ({limit})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spira_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    from .utils.config import add_render_args

    pr = sub.add_parser("render", help="render a scene")
    add_render_args(pr)
    pr.set_defaults(fn=_cmd_render)

    pi = sub.add_parser("inverse", help="inverse-rendering Adam loop")
    add_render_args(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--target", default=None,
                    help="EXR target image (default: self-synthesized)")
    pi.set_defaults(fn=_cmd_inverse)

    pn = sub.add_parser("info", help="show the torch and CUDA versions and "
                        "the cards")
    pn.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
