"""Where the packed-BVH kernel's time goes, and whether bfloat16 is a
lever: the counterpart of ``benchmarks/packet_profile.py``.

    python3 -m spira_tpu_torch.bench.packet_profile [--tier counters|vpu|all]
                                                   [--out PATH]

* ``vpu`` (kernel #10): float32 against bfloat16 elementwise rate.  Each
  element steps ``acc = acc * c1 + x * c2`` ``CHAIN`` times from
  ``acc = x`` in the chosen type (``x * c2`` is the same every step, so
  the kernel computes it once), output in float32.  Counted as
  ``benchmarks/packet_profile.py:123`` counts it, 2 flops a step; a step
  is 2 instructions an element in float32 (FMUL, FADD) and 2 for two
  elements in bfloat16 pairs (HMUL2, HADD2).  On the card :func:`vpu_dtype`
  launches ``csrc/peak.cu:spira_vpu_dtype`` and adds one to
  ``vpu_dtype.launches``; on the CPU it runs :func:`vpu_dtype_plain`.
  Reported at the JAX tile (256 x 128) and at a grid that fills every SM,
  on an input that varies by element (the JAX script's is all 0.5).
* ``counters`` (kernel #2's counting build): the three mesh tiers of the
  JAX script, the 1,600- and 5,440-triangle mesh scenes and the
  72,960-triangle procedural bunny, at 640x360, spp 16, depth 4 on
  ``cuda_bvh``: each tier's uncounted and counting kernel times and its
  counters (:func:`~spira_tpu_torch.kernels.bvh_megakernel.
  render_bvh_with_counters`), then the least-squares fit
  time ~ pops * c_pop + leaf_tris * c_leaf + traversals * c_trav over the
  tiers, as ``benchmarks/packet_profile.py:67-79`` fits its counters.

Every row is a JSON line on stdout, with the card's name and power limit;
``--out`` also appends the rows to a file.  Nothing is written under
``benchmarks/``.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from .. import _build
from . import timing
from . import vpu_peak

ROWS, COLS, CHAIN = 256, 128, 512
C1, C2 = 1.0000001, 0.9999999
#: flops counted a step, as benchmarks/packet_profile.py:123 counts them
FLOPS_PER_STEP = 2
#: instructions an element-step as nvcc builds it (read in the SASS)
INSTRUCTIONS = {"f32": 2, "bf16": 1}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: the fill grid: every SM's resident threads this many times over
#: (float32: one element a thread; bfloat16: two)
WAVES = 16
W, H, SPP, DEPTH = 640, 360, 16, 4
#: the JAX script's tiers: (name, mesh subdivisions or None for the bunny)
TIERS = (("mesh1600", 3), ("mesh5440", 4), ("bunny", None))


def vpu_dtype_plain(x, dtype: str = "f32", steps: int = CHAIN):
    """The plain version of kernel #10: ``steps`` steps of
    ``acc = acc * c1 + x * c2`` in ``dtype`` (each operation rounded to it)
    from ``acc = x``, returned as float32."""
    t = DTYPES[dtype]
    xv = x.to(t)
    c1 = torch.tensor(C1, dtype=t, device=x.device)
    c2 = torch.tensor(C2, dtype=t, device=x.device)
    acc = xv
    for _ in range(steps):
        acc = acc * c1 + xv * c2
    return acc.to(torch.float32)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def vpu_dtype(x, dtype: str = "f32", steps: int = CHAIN):
    """Kernel #10 on float32 ``x``: float32, ``x``'s shape.

    A tensor on a CUDA device launches ``csrc/peak.cu:spira_vpu_dtype``
    (built on first use) and adds one to ``vpu_dtype.launches``; a tensor
    on the CPU runs :func:`vpu_dtype_plain`.  bfloat16 takes an even
    element count.  Any other device, dtype or input raises."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {tuple(DTYPES)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if x.device.type == "cpu":
        return vpu_dtype_plain(x, dtype, steps)
    if x.device.type != "cuda":
        raise ValueError(f"vpu_dtype runs on cuda or cpu, not {x.device}")
    if dtype == "bf16" and x.numel() % 2:
        raise ValueError("bf16 steps element pairs: x needs an even size")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    fn = _build.entry("peak", "spira_vpu_dtype", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), out.data_ptr(), xc.numel(), steps,
                 int(dtype == "bf16"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vpu_dtype launch failed: CUDA error {err}")
    vpu_dtype.launches += 1
    return out


#: Kernel launches since the count was last reset (set it to 0 to reset).
vpu_dtype.launches = 0


def flops_per_launch(n: int, steps: int = CHAIN) -> int:
    return FLOPS_PER_STEP * steps * n


def time_dtypes(x, steps: int = CHAIN, repeats: int = timing.REPEATS):
    """``({dtype: ms}, {dtype: output})``: the median time of one launch on
    ``x`` by CUDA events, and the output of the last timed launch."""
    outs = {}

    def launch(dtype):
        outs[dtype] = vpu_dtype(x, dtype, steps)

    ms = {d: timing.cuda_ms(lambda d=d: launch(d), repeats) for d in DTYPES}
    return ms, outs


def tier_vpu(device, out=None, card=None):
    """Kernel #10 at the JAX tile and at the fill grid, on
    :func:`~spira_tpu_torch.bench.vpu_peak.probe_input`: ``(rows,
    outputs)``, one row per grid and dtype with ms and GFLOP/s, and each
    launch's output by ``(grid, dtype)``."""
    card = card or timing.card_line()
    rows, outputs = [], {}
    for grid, n in (("jax", ROWS * COLS),
                    ("fill", vpu_peak.fill_elements(device, WAVES))):
        ms, outs = time_dtypes(vpu_peak.probe_input(n, device))
        for dtype, t in ms.items():
            outputs[grid, dtype] = outs[dtype]
            rows.append(timing.record(
                out, tier="vpu", card=card, grid=grid, elements=n,
                dtype=dtype, ms=t,
                gflop_s=flops_per_launch(n) / (t * 1e-3) / 1e9,
                instructions_per_element_step=INSTRUCTIONS[dtype]))
    return rows, outputs


def tier_scene(name, subdivisions, device):
    """(scene, camera, triangles) of a counters tier at W x H."""
    import spira_tpu_torch as sp

    if subdivisions is None:
        scene, info = sp.create_bunny_scene(allow_download=False,
                                            device=device)
        return scene, sp.bunny_camera(W / H, device=device), \
            int(info["triangles"])
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=subdivisions,
                                                  device=device))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=W / H, device=device)
    return scene, cam, int(scene.triangles.count)


def fit_costs(rows) -> dict:
    """Least-squares per-unit costs (ns) of time ~ pops * c_pop +
    leaf_tris * c_leaf + traversals * c_trav over the tiers' rows."""
    a = np.array([[r["pops"], r["leaf_tris"], r["traversals"]]
                  for r in rows], float)
    b = np.array([r["ms"] * 1e-3 for r in rows])
    coef, res, rank, _ = np.linalg.lstsq(a, b, rcond=None)
    return dict(ns_per_pop=coef[0] * 1e9, ns_per_leaf_tri=coef[1] * 1e9,
                ns_per_traversal=coef[2] * 1e9, rank=int(rank),
                residual=float(res[0]) if len(res) else None)


def tier_counters(device, out=None, card=None) -> list:
    """Kernel #2 and its counting build on the three tiers, then the fit."""
    from ..kernels.bvh_megakernel import (
        render_bvh_with_counters,
        render_flat_bvh_megakernel,
    )

    card = card or timing.card_line()
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)
    rows = []
    for name, subdivisions in TIERS:
        scene, cam, tris = tier_scene(name, subdivisions, device)
        ms = timing.cuda_ms(lambda: render_flat_bvh_megakernel(
            scene, cam, **kw), 5)
        ms_counted = timing.cuda_ms(lambda: render_bvh_with_counters(
            scene, cam, **kw), 5)
        _, ctr = render_bvh_with_counters(scene, cam, **kw)
        rays = W * H * SPP * DEPTH
        rows.append(timing.record(
            out, tier="counters", card=card, scene=name, tris=tris, ms=ms,
            mrays_s=rays / (ms * 1e-3) / 1e6, ms_with_counters=ms_counted,
            **ctr))
    fit = timing.record(out, tier="counters", card=card, scene="fit",
                        **fit_costs(rows))
    return rows + [fit]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", default="all",
                    choices=["counters", "vpu", "all"])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    device = timing.require_cuda("packet_profile")
    card = timing.card_line()
    tiers = ["vpu", "counters"] if args.tier == "all" else [args.tier]
    for tier in tiers:
        dict(vpu=tier_vpu, counters=tier_counters)[tier](device, args.out,
                                                         card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
