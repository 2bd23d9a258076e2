"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: requires CUDA, prints the card's name and power
   limit, the torch/CUDA versions, and builds the kernels from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, same scene
   tables and seed, with the tolerances stated in ``CASES``;
3. the main path: ``spira_tpu_torch.render`` of the demo scene at 640x360,
   spp 16, depth 4, on ``cuda``, with the kernel's launch count read around
   it and the image checked against the plain version's render;
4. timing with CUDA events (one warm-up, median of ``REPEATS``), and a
   torch.profiler breakdown of the main-path wrapper's time on the card.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPEATS = 5
MAIN = dict(width=640, height=360, spp=16, max_depth=4)
#: (name, scene function, camera function, shape, tolerances).  Depth 1 sees
#: only primary hits and raygen jitter; deeper paths may take another branch
#: where a transcendental differs in its last bit, which moves a whole path.
CASES = (
    ("a: demo 640x360 spp1 d1", "create_scene", "default_camera",
     dict(width=640, height=360, spp=1, max_depth=1),
     dict(atol=1e-5, frac=0.999, mean_rel=0.005)),
    ("b: demo 640x360 spp16 d4", "create_scene", "default_camera",
     MAIN, dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
    ("c: cornell 256x256 spp16 d6", "create_cornell_box", "cornell_camera",
     dict(width=256, height=256, spp=16, max_depth=6),
     dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats=REPEATS):
    """Median wall time on the card of ``fn()``, by CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn, runs=REPEATS):
    """Kernel time on the card by name over ``runs`` calls of ``fn``
    (torch.profiler), and the card's idle share of the host's window."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # "void at::native::foo_kernel<...>(...)" -> "at::native::foo_kernel"
            name = re.split(r"[<(]", e.name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    return dict(
        runs=runs,
        wall_ms_per_call=wall_us / runs / 1e3,
        device_ms_per_call=busy_us / runs / 1e3,
        idle_share=1.0 - busy_us / wall_us if by_name else None,
        kernels_ms_per_call={k: v / runs / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])},
    )


def compare(sp, mk, name, scene_fn, cam_fn, shape, tol, device):
    scene = getattr(sp, scene_fn)(device=device)
    w, h = shape["width"], shape["height"]
    cam = getattr(sp, cam_fn)(w / h, device=device)
    kernel = mk.render_flat_megakernel(scene, cam, seed=7, **shape)
    plain = mk.render_flat_fused(scene, cam, seed=7, **shape)
    torch.cuda.synchronize()
    if kernel.shape != (w * h, 3) or not torch.isfinite(kernel).all():
        raise AssertionError(f"{name}: kernel output bad shape or not finite")
    diff = (kernel - plain).abs()
    max_abs = float(diff.max())
    frac_off = float((diff > tol["atol"]).float().mean())
    km, pm = kernel.mean(0).tolist(), plain.mean(0).tolist()
    rel = max(abs(a / b - 1.0) for a, b in zip(km, pm))
    log(f"[compare] {name}: max_abs {max_abs:.3e}, "
        f"share > {tol['atol']:g}: {frac_off:.6f} "
        f"(limit {1 - tol['frac']:.4f}), channel means kernel "
        f"{[round(x, 6) for x in km]} plain {[round(x, 6) for x in pm]}, "
        f"max rel {rel:.2e} (limit {tol['mean_rel']})")
    if frac_off > 1.0 - tol["frac"] or rel > tol["mean_rel"]:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return dict(case=name, max_abs_err=max_abs, share_over_atol=frac_off,
                mean_rel=rel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1

    # ---- 1. card and toolchain
    import spira_tpu_torch as sp
    from spira_tpu_torch import _build
    from spira_tpu_torch.kernels import megakernel as mk

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    lib = _build.load("megakernel")
    log(f"[build] megakernel: {lib.build_seconds:.1f} s "
        f"({'built' if lib.build_seconds else 'cached'}) -> {lib.path.name}")

    # ---- 2. kernel against its plain version on the card
    checks = [compare(sp, mk, *case, device) for case in CASES]

    # ---- 3. the main path, through the user's entry point
    w, h = MAIN["width"], MAIN["height"]
    scene = sp.create_scene(device=device)
    cam = sp.default_camera(w / h, device=device)
    args = dict(samples_per_pixel=MAIN["spp"], max_depth=MAIN["max_depth"])
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "chip_smoke.png")
        mk.render_flat_megakernel.launches = 0
        img = sp.render(scene, cam, w, h, output_path=png, **args)
        torch.cuda.synchronize()
        launches = mk.render_flat_megakernel.launches
        png_bytes = os.path.getsize(png)
    plain_img = sp.render(scene, cam, w, h, engine="fused", **args)
    level_gap = abs(float(img.mean()) - float(plain_img.mean()))
    log(f"[main] render {w}x{h} spp{MAIN['spp']} d{MAIN['max_depth']}: "
        f"image {img.shape} {img.dtype}, mean {img.mean():.4f} "
        f"(plain {plain_img.mean():.4f}), std {img.std():.4f}, "
        f"png {png_bytes} bytes, megakernel launches {launches}")
    if launches < 1:
        raise AssertionError("main path did not launch the megakernel")
    if img.shape != (h, w, 3) or img.std() == 0 or png_bytes == 0:
        raise AssertionError("main path image is empty or constant")
    if level_gap > 1.0:
        raise AssertionError(f"uint8 means differ by {level_gap} > 1 level")

    # ---- 4. timing
    def kernel_run(width, height, spp, max_depth):
        return lambda: mk.render_flat_megakernel(
            scene, cam, width=width, height=height, spp=spp,
            max_depth=max_depth)

    def plain_run(width, height, spp, max_depth):
        return lambda: mk.render_flat_fused(
            scene, cam, width=width, height=height, spp=spp,
            max_depth=max_depth)

    def mrays(shape, ms):
        rays = shape["width"] * shape["height"] * shape["spp"] \
            * shape["max_depth"]
        return rays / (ms * 1e-3) / 1e6

    k_ms = time_ms(kernel_run(**MAIN))
    p_ms = time_ms(plain_run(**MAIN))
    big = dict(width=1920, height=1080, spp=256, max_depth=4)
    big_ms = time_ms(kernel_run(**big))
    log(f"[time] {card}: 640x360 spp16 d4 kernel {k_ms:.3f} ms "
        f"({mrays(MAIN, k_ms):.1f} Mrays/s), plain {p_ms:.3f} ms "
        f"({mrays(MAIN, p_ms):.1f} Mrays/s), kernel/plain "
        f"{k_ms / p_ms:.4f}")
    log(f"[time] {card}: 1920x1080 spp256 d4 kernel {big_ms:.3f} ms "
        f"({mrays(big, big_ms):.1f} Mrays/s)")
    if k_ms > p_ms:
        log("[time] the kernel is SLOWER than the plain version")
    if not all(math.isfinite(x) for x in (k_ms, p_ms, big_ms)):
        raise AssertionError("timing failed")
    # where the wrapper's time goes: the megakernel against the small
    # table-packing launches before it, and the card's idle share
    breakdown = device_breakdown(kernel_run(**MAIN))
    if breakdown["idle_share"] is None:
        log("[profile] no device time in the trace: not measured")
    else:
        top = list(breakdown["kernels_ms_per_call"].items())[:4]
        log(f"[profile] {card}: 640x360 spp16 d4 wrapper "
            f"{breakdown['wall_ms_per_call']:.4f} ms/call on the host, "
            f"{breakdown['device_ms_per_call']:.4f} ms/call on the card, "
            f"idle share {breakdown['idle_share']:.4f}; top kernels "
            f"(ms/call): {[(k, round(v, 5)) for k, v in top]}")

    main_check = checks[1]
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "spira_tpu_torch/csrc/megakernel.cu",
        "replaces": "spira_tpu/kernels/megakernel.py:504",
        "launches": launches,
        "max_abs_err": main_check["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "ms_1920x1080_spp256": big_ms,
        "profile_640x360_spp16_d4": breakdown,
        "checks": checks,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
