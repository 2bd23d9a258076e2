"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py [--save DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: requires CUDA, prints the card's name and power
   limit, the torch/CUDA versions, and builds the kernels from ``csrc/``
   (one nvcc per source, all started together), with each kernel's
   registers, stack and spills from ``ptxas -v``;
1b. the peak-rate probes (``spira_tpu_torch.bench``): kernel #9 in every
   mode and #10 in float32 and bfloat16 against their plain versions at
   the JAX shapes, on the JAX probes' inputs and on an input that varies
   by element; then the profilers' runs (``vpu_peak.time_modes``,
   ``packet_profile.tier_vpu``) at a grid that fills every SM, with launch
   counts, each launch's output held against its plain version on the
   same input; #9's rates give the special-function weights
   (``vpu_peak.sol_rates``) that price every bound below;
2. each kernel against its plain PyTorch version on the card, same tables
   and seed, with the tolerances stated beside each case: the sphere
   megakernel (``SPHERE_CASES``, also to the bit), the packed-BVH
   nearest-hit query on
   random and primary rays of the 72,960-triangle bunny, the packed-BVH
   path tracer (``BVH_CASES``), the spectral megakernel
   (``SPECTRAL_CASES``, also to the bit), the spectral packed-BVH path tracer
   (``SPECTRAL_BVH_CASES``), the adjoint kernels against autograd
   through the plain tracer (``GRAD_CASES``: VJP mode and loss mode, a
   ragged grid, the full 16-bounce tape, ``inclusive_uv=False``, a camera
   inside a sphere), loss mode's loss against the MSE of kernel #1's
   image, with a central-difference check of its gradients, the
   streaming superleaf query on the bunny's random and primary rays (to
   the bit), and the streaming superleaf path tracer and the
   superleaf-leaf BVH path tracer (``MXU_CASES``, to the bit; #7 on both
   of its routes, the staged one by size on the mesh and the read-only
   one by size on the bunny and forced on the mesh; #2b also on a scene
   whose every hit is a tie within a block and across two blocks of one
   walk, ``bench/superleaf.py:tie_scene``); the counting build
   of the packed-BVH path tracer on the bunny: its image bit-equal to the
   uncounted kernel's, its totals equal to the plain counting walk's, and
   pops == traversals + pushes; the wavefront estimator's frame on the
   bunny (``render_flat``, ``WAVEFRONT_PLAIN``) with every bounce's
   nearest hits from kernel #3, bit-equal to the same frame with the hook
   on #3's plain version; and #3 at the main path's shape and mode: each
   bounce of the main path's first sample at 640x360 (the slot asked for,
   a partly dead ``active``), its outputs bit-equal to the plain walk's;
   the mesh step's backward (``render_flat_hybrid_grad_mesh``, #3 in its
   replay) against the same replay through the plain hook, the same
   cotangent, at ``WAVEFRONT_PLAIN``'s shape: RGB (albedo, camera origin,
   triangle v0) and spectral (``albedo_spd``), each field to the bit;
3. the main paths, through the user's entry points, each with every launch
   count set to 0 just before and read just after: ``render`` of the bunny
   at 640x360, spp 16, depth 4 (engine ``cuda_bvh``), the same through
   ``render_bvh_with_counters`` (the counting build), ``intersect_tile``
   on the bunny's primary rays, ``render`` of the sphere demo scene at the
   same shape (engine ``cuda``), and ``render(..., spectral=True)`` of the
   Cornell box (engine ``cuda``, the spectral megakernel) and of the bunny
   (engine ``cuda_spectral_bvh``) at the same shape; each image is checked
   against the plain version's render, and the spectral Cornell box
   against the RGB one; then the differentiable step of ``bench.py``
   (``render_flat_hybrid_grad``, MSE, ``backward``) on the sphere demo at
   exact replay and at ``grad_spp=4``, a few gradient-descent updates of
   the albedo, each step one forward and one adjoint launch and no plain
   tracer call; ``render_mse_loss_and_grads`` there, one launch of loss
   mode's forward kernel and one of the VJP kernel; and the superleaf
   engines: ``render`` of the bunny on
   ``cuda_bvh_mxu`` and of the 1,600-triangle mesh scene on ``cuda_mxu``
   at 640x360, spp 16, depth 4, each one launch and no plain call (#7 on
   its staged route), each image held against its plain version (to the
   bit) and against ``cuda_bvh``'s image
   of the same scene and seed, and ``intersect_tile_mxu`` on the bunny's
   primary rays, held against the packed-BVH query; the wavefront
   estimator: ``render_flat`` of the bunny at 640x360, spp 16, depth 4,
   64 launches of #3 (one a bounce) and nothing else; ``render_flat_engine
   (engine="wavefront")`` against ``cuda_bvh`` and, spectrally, against
   ``cuda_spectral_bvh`` on the bunny, each within NOISE_FLOOR_MULT x the
   wavefront's two-seed noise floor; ``render_with_cpu`` of the sphere
   demo at the same shape (no kernel, no plain tracer), and
   ``render_flat`` in reference semantics on the card against the same
   call on the CPU; ``render(engine="bvh_sorted")`` of the bunny, equal to
   ``render_flat(grad_hook=False)``'s image to the bit, 64 launches of #3;
   the mesh step of ``bench.py`` (``render_flat_hybrid_grad_mesh`` at
   640x360, spp 16, depth 4, ``grad_spp=2``, ``img.mean()``, the albedo's
   gradient; spectrally the SPD albedo's): one launch of #2 (#5) whose
   image equals ``render_flat_engine``'s to the bit, #3's launches in the
   backward (``render.mesh_replay_launches``) and nothing else, the
   gathers' backward (``row_gather_backward``) one launch a bounce of each
   replayed sample but the last (whose albedo reaches nothing), the
   gradient finite and nonzero on the bunny's material;
3b. the command line, through ``cli.main`` at the demo preset (640x360,
   depth 4), each path with the launch counts set to 0 just before it and
   read just after (``[cli]`` lines; each path joins the kernels line
   under the kernel it launches, as ``cli_paths`` with its ``cli_*``
   label): ``render --spp 16 --seed 0`` of the sphere demo, the bunny, the
   spectral Cornell box and the spectral bunny, each one launch of its
   kernel (#1, #2, #4, #5) and nothing else, its PNG
   ``to_uint8(tonemap(render_hdr(...)))`` of the same arguments to the
   bit, with its wall time and Mrays/s; ``--adaptive-tol 0.05`` on the
   bunny twice, #3 only, the same image both times, with its samples
   saved against uniform spp, rounds and host syncs; ``--shading
   preview`` and ``normal`` on the bunny, one #3 launch each, the image
   equal to the preview through #3's plain version to the bit;
   ``--checkpoint-dir D --checkpoint-every 4`` on the sphere demo stopped
   after 8 samples (its third chunk raises), resumed, equal to the
   uninterrupted run and to the one-shot wavefront render to the bit;
   ``inverse --steps 3 --spp 4`` on the sphere demo (the wavefront's
   autograd, no kernel) and on the bunny (#3's slot form only), every
   loss finite, the albedo moved, with ms a step and peak memory (a main
   path here is one ``step`` call: the target's render is not counted);
   and ``info``, whose output names the card; the checkpoints go into a
   temporary directory, only the PNGs into ``--save``;
3c. sharding on the card: ``bvh_rows`` (kernel #2) and its superleaf
   form (#2b) on the bunny at rows 90-179 and samples 8-11 of 640x360 d4,
   equal to their plain versions to the bit; the bunny at 640x360 spp16
   d4 and at BASELINE config 5's 1920x1080 spp256 as a 4x1 split of
   ``bvh_rows``, equal to the unsharded #2 frame to the bit; then, each
   rank a process of ``spira_tpu_torch/bench/sharded_world.py`` on this
   card, a 2-rank gloo world (``render_flat_sharded`` of the bunny on
   ``cuda_bvh`` at 2x1, equal to the unsharded frame to the bit, and at
   1x2, within the float-sum bound; on ``wavefront`` at 2x1, #3's launches
   a rank, and equal to the same shard body through #3's plain hook to
   the bit; one sharded inverse step, the parameters equal on both ranks;
   ``cli render --scene bunny --n-tile 2``, its PNG the gathered sharded
   render's) and a 1-rank NCCL world (``cli render --n-tile 1``);
   ``[sharded]`` lines with each rank's wall time, launches, collective
   bytes and the gather's and all-reduces' times; each rank's sharded
   calls count as main paths, and join the kernels line under the kernel
   they launch (``sharded_paths``);
3d. the bunny over an SBVH (``accel/bvh.py:build_sbvh_for_triangles`` at
   the bunny's leaf size 8: spatial splits duplicate references, so
   ``prim_idx`` is longer than the triangle count), packed: its build
   seconds, references a triangle and node count; #2 at 640x360 spp16 d4
   and #5 at spp 4 equal to their plain versions to the bit, and #2 within
   the image tolerances of the SAH tree's frame; #3 on the bunny's primary
   rays equal to its plain walk to the bit, and there and on
   ``render_flat``'s four recorded calls of a sample the SAH tree's hit
   set and material ids, t within ``SBVH_T_RTOL``; ``render`` (RGB and
   spectral, one #2 or #5 launch) and ``render_flat`` (#3 a bounce) over
   it with the counts set to 0 just before and read just after; #2's
   counted walk on both trees, and #2, #3 and #5 timed over both trees on
   the same calls (``[sbvh]`` lines);
3e. the examples (``spira_tpu_torch/examples``), each through its
   ``__main__`` with the JAX script's arguments (the inverse loop at
   ``EXAMPLE_STEPS`` steps) and the counts set to 0 just before and read
   just after: its image read back (shape, not constant) or its printed
   losses (finite), its kernel launched, and a reduced frame of its scene
   through the kernel within 0.5% of the plain version's channel means;
   ``distributed_render`` as two ranks on this card (gloo), its gathered
   PNG read back; ``[examples]`` lines with each one's wall seconds;
3f. the material gathers' backward (``kernels/row_gather.py``,
   ``row_gather_phase``): on ``ROW_GATHER_CASES`` the kernel bit-equal
   over three launches and to ``index_put_(accumulate=True)``, whose order
   it keeps, and within ``ROW_GATHER_SUM_RTOL`` of its plain version
   (``index_add_`` into zeros); then timed at the bunny step's shape
   beside both (``index_put_`` its ``library_ms``), with its time on the
   card, its byte bound and the bound of its chain of adds
   (``[row_gather]`` lines);
4. timing with CUDA events (one warm-up, median of 10, of
   ``PLAIN_REPEATS`` for the plain versions), and a
   torch.profiler breakdown of the main-path wrappers' time on the card
   and the host's share of each (the wrapper's time less the device's);
   each kernel's bound from the work this run's inputs need (counted
   with the plain versions, #2's by its counting build and held against
   the plain count), priced by ``utils/sol.py``: the largest of the ALU
   instructions at the card's issue rate (128 lanes a clock an SM at the
   max SM clock), the special-function calls times the weights phase 1b
   measured at the same rate, and the bytes over the memory rate, with
   the data-sheet bound (every operation over 67 TFLOP/s) beside it; the
   probes' bound is their counted operations at the issue rate; each
   kernel's share of its bound and launches x (time - bound), largest
   first; the superleaf kernels beside ``cuda_bvh`` on the same calls,
   #7's and #8's bounds over the real lanes they test, with the bound had
   every block's 128 lanes been tested beside them; #2b's over the lanes
   it tests (the real lanes of the lane groups the ray enters) and the
   group boxes, with the bound over every real lane of the blocks it
   visits and over all 128 beside it; ``[2b]`` lines: #2b's counting
   build on the bunny at spp 4 and 16 (its image the uncounted kernel's,
   its walks, pops, blocks, lanes tested and hits the plain count's),
   blocks visited, boxes tested, lanes tested and skipped per walk, and
   its time beside both bounds;
   the counting build's time beside the uncounted one; the adjoint
   kernels and the step through ``spira_tpu_torch/bench/grad_step.py``
   (VJP at grad_spp 16 and 4, a zero cotangent, loss mode and its
   forward kernel alone, the step at both grad_spp), the VJP bounds at
   both grad_spp beside loss mode's; ``[rank]`` lines weigh each kernel
   by its launches in one call of a main path, counted in phases 3 and
   3b: one render() under engine="auto" (the bunny, the sphere demo, and
   both spectrally), one step, one render_mse_loss_and_grads, one
   render_flat of the bunny (the wavefront entry), one mesh step (RGB,
   spectral), one command of phase 3b (the 3-step inverse command on the
   bunny included); the most over those paths, 0 for a kernel none of
   them launched; each kernel's time
   and bound at the main paths' shape, 640x360 spp16 d4 (#2's work from
   its counting build there, the other path tracers' from their plain
   versions there; #8 at that frame's primary rays; #3 on the four calls
   of ``render_flat``'s first sample recorded in phase 2, ``[bounce]``
   lines: each call's live share, time (CUDA events) and time by kernel
   (``torch.profiler``), plain time, and bound from the plain walk's work
   on that call's live rays, the four bounds summed);
   beside #2's and #5's bounds, the bytes their walks touch a frame and
   the rate that implies; the wavefront frame
   (``spira_tpu_torch/bench/wavefront_frame.py`` in a process of its own,
   ``[wavefront]`` lines): its wrapper time, its time on the card, #3's
   launches in the profiled frame and its share of the device time, the
   device operations a frame, the idle share and the threefry draws'
   share, and the spectral frame's and ``render_with_cpu``'s wrapper
   times; #3 is ranked by its launches on ``render_flat`` and its time a
   launch there (its profiled time over its profiled launches) against
   the mean of its four calls' bounds; the mesh step in a process of its
   own (``spira_tpu_torch/bench/grad_step.py --mesh``, ``[mesh_step]``
   lines, RGB and spectral): the step, its forward and backward (CUDA
   events, median of 5), its launches, its time on the card, device
   operations and idle share (``torch.profiler``), and the peak memory of
   the step and of the backward's replay.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  ``--save DIR`` also writes the main
paths' PNGs there; ``--parent DIR`` also times another commit's adjoint
kernel and step (a ``git archive`` of it unpacked into ``DIR``) with
``spira_tpu_torch/bench/grad_step.py``, its frames (#2, #5, #2b, #3
on the bunny, #1 and #4 at 640x360 spp16 d4 and 1920x1080 spp256, with
their host share, ``ptxas -v`` and #1's and #4's occupancy) beside this
tree's with ``spira_tpu_torch/bench/mesh_frame.py``, its #3 on the
wavefront's four calls of a sample with
``spira_tpu_torch/bench/intersect_bounces.py``, and its superleaf kernels
(#7 on the mesh at spp 4 and 16, #8 on the bunny's primary rays, #2b on
the bunny at spp 4 and 16) with ``spira_tpu_torch/bench/superleaf.py``
(each parent, this, this, parent), each run in a process of its own;
every image and every output of #3, #7, #8 and #2b of both commits must
agree to the bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: the plain versions, seconds a call, are reference only: timed this
#: many times (the kernels bench.timing.REPEATS times)
PLAIN_REPEATS = 2
MAIN = dict(width=640, height=360, spp=16, max_depth=4)
MAIN_SHAPE = "640x360 spp16 d4"
#: the peak-rate probes' comparisons: the separate
#: multiply-add and kernel #10 bit-equal; the contracted step (plain
#: version: the float64 sum rounded once, so a double rounding may move a
#: last bit) within PEAK_FMA_ULP units in the last place of the chains'
#: sums; the special-function chains (torch's calls on the card against
#: nvcc's, the same precise library functions) within PEAK_SPECIAL_RTOL
PEAK_FMA_ULP, PEAK_SPECIAL_RTOL = 4, 1e-6
#: the shape the kernel table of PERF.md times the BVH kernel and its
#: plain version at
BVH_TIMED = dict(width=640, height=360, spp=4, max_depth=4)
#: sphere megakernel cases: (name, scene function, camera function, shape,
#: tolerances).  Each is held equal to the plain version to the bit (the
#: same operations in the same order) and within its tolerances, the limit
#: of the engines that are not held to the bit: depth 1 sees only primary
#: hits and raygen jitter; deeper paths may take another branch where a
#: transcendental differs in its last bit, which moves a whole path.
SPHERE_CASES = (
    ("a: demo 640x360 spp1 d1", "create_scene", "default_camera",
     dict(width=640, height=360, spp=1, max_depth=1),
     dict(atol=1e-5, frac=0.999, mean_rel=0.005)),
    ("b: demo 640x360 spp16 d4", "create_scene", "default_camera",
     MAIN, dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
    ("c: cornell 256x256 spp16 d6", "create_cornell_box", "cornell_camera",
     dict(width=256, height=256, spp=16, max_depth=6),
     dict(atol=1e-4, frac=0.99, mean_rel=0.005)),
)
#: packed-BVH path tracer cases: (name, scene key, shape).  Equal to the
#: plain version to the bit (the same operations in the same order, the
#: samples of a pixel summed in sample order); BVH_TOL (at least 99% of
#: pixel-channels within 1e-4, channel means within 0.5%) is the limit of
#: the engines that are not held to the bit.
BVH_TOL = dict(atol=1e-4, frac=0.99, mean_rel=0.005)
BVH_CASES = (
    ("d: bunny 640x360 spp1 d2", "bunny",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("e: bunny 640x360 spp4 d4", "bunny", BVH_TIMED),
    ("f: mesh 256x256 spp4 d4", "mesh",
     dict(width=256, height=256, spp=4, max_depth=4)),
)
#: nearest-hit query limits: miss sets equal but for this share of rays;
#: t on common hits to this relative tolerance; material id equal on this
#: share; normal within NORMAL_ATOL on this share.
MISS_SHARE, T_RTOL, MID_SHARE = 1e-4, 1e-5, 0.9999
NORMAL_ATOL, NORMAL_SHARE = 1e-5, 0.999
N_RANDOM_RAYS = 1 << 16
#: spectral megakernel cases: (name, scene key, shape, tolerances), held
#: to the bit and to limits as for the sphere megakernel.  The Cornell
#: box's flint glass disperses (the hero collapse), and depth 6 runs
#: Russian roulette.
SPECTRAL_CASES = (
    ("g: demo 640x360 spp1 d1", "demo",
     dict(width=640, height=360, spp=1, max_depth=1),
     dict(atol=1e-5, frac=0.999, mean_rel=0.005)),
    ("h: cornell 256x256 spp16 d6", "cornell_sq",
     dict(width=256, height=256, spp=16, max_depth=6), BVH_TOL),
    ("i: cornell 640x360 spp16 d4", "cornell", MAIN, BVH_TOL),
)
#: spectral packed-BVH cases: (name, scene key, shape), equal to the bit
SPECTRAL_BVH_CASES = (
    ("j: bunny 640x360 spp1 d2", "bunny",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("k: bunny 640x360 spp4 d4", "bunny", BVH_TIMED),
    ("l: dispersive icosphere 256x256 spp4 d6", "dispersive",
     dict(width=256, height=256, spp=4, max_depth=6)),
)
#: adjoint-kernel cases: (name, scene key, shape, grad_spp, loss mode).
#: VJP mode takes a seeded random cotangent; loss mode a target rendered
#: by the plain tracer at seed 99.  Limits: loss within GRAD_LOSS_RTOL
#: relative, each table's gradient within GRAD_REL_L2 of the plain
#: autograd backward's, in relative L2 norm (float atomics sum in a
#: different order, and paths near silhouettes amplify the last bits).
GRAD_CASES = (
    ("m: demo 128x64 spp4 d4 vjp", "demo",
     dict(width=128, height=64, spp=4, max_depth=4), 4, False),
    ("n: demo 640x360 spp16 d4 grad_spp4 vjp", "demo", MAIN, 4, False),
    ("o: thin-lens demo 256x128 spp4 d3 vjp", "lens",
     dict(width=256, height=128, spp=4, max_depth=3), 4, False),
    ("p: cornell 256x256 spp4 d6 vjp", "cornell_sq",
     dict(width=256, height=256, spp=4, max_depth=6), 4, False),
    ("q: demo 640x360 spp16 d4 loss", "demo", MAIN, 16, True),
    # 641 * 359 * 3 replayed samples: a ragged last chunk, and warps whose
    # lanes straddle pixels
    ("w: demo 641x359 spp3 d4 grad_spp3 vjp", "demo",
     dict(width=641, height=359, spp=3, max_depth=4), 3, False),
    # the tape's full depth: 96 KB of tape a block, past the 48 KB a
    # launch gets without opting in
    ("x: thin-lens demo 256x128 spp2 d16 vjp", "lens",
     dict(width=256, height=128, spp=2, max_depth=16), 2, False),
    ("y: demo 256x128 spp4 d4 vjp exclusive uv", "demo",
     dict(width=256, height=128, spp=4, max_depth=4, inclusive_uv=False), 4,
     False),
    # inside the emissive sphere: every lane adds to one record (VJP mode:
    # the image there is the same at every seed, so a loss against another
    # seed's render is 0)
    ("z: inside the light 256x128 spp4 d4 vjp", "inside",
     dict(width=256, height=128, spp=4, max_depth=4), 4, False),
)
#: loss mode's loss against the MSE of kernel #1's image on the same
#: target and seed: float32 pixel sums, double block sums
LOSS_FORWARD_RTOL = 1e-6
GRAD_LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-3
#: superleaf path tracer cases, limits BVH_TOL: (name, engine, scene key,
#: shape); "mxu" is the streaming kernel #7, "bvh_mxu" the packed-BVH walk
#: with superleaf leaves #2b
MXU_CASES = (
    ("r: #7 mesh 256x256 spp4 d4", "mxu", "mesh_mxu",
     dict(width=256, height=256, spp=4, max_depth=4)),
    ("s: #7 mesh 640x360 spp1 d2", "mxu", "mesh_mxu_wide",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("t: #2b bunny 640x360 spp1 d2", "bvh_mxu", "bunny_sl",
     dict(width=640, height=360, spp=1, max_depth=2)),
    ("u: #2b bunny 640x360 spp4 d4", "bvh_mxu", "bunny_sl", BVH_TIMED),
    ("v: #2b mesh 256x256 spp4 d4", "bvh_mxu", "mesh_sl",
     dict(width=256, height=256, spp=4, max_depth=4)),
    # every hit a tie: within a block (the lower lane wins) and across two
    # blocks of one walk (the block visited first wins)
    ("w: #2b ties 256x256 spp4 d4", "bvh_mxu", "ties_sl",
     dict(width=256, height=256, spp=4, max_depth=4)),
    # #7's read-only route: forced on the mesh, and where the bunny's
    # 72,960 lanes do not fit a block's shared memory
    ("r2: #7 mesh 256x256 spp4 d4 read-only route", "mxu_global",
     "mesh_mxu", dict(width=256, height=256, spp=4, max_depth=4)),
    ("s2: #7 bunny 160x90 spp1 d2 read-only route", "mxu", "bunny_mxu",
     dict(width=160, height=90, spp=1, max_depth=2)),
)
#: the differentiable step: albedo of the red sphere and the ground
#: perturbed as in tests/test_grad.py, plain gradient descent
STEP_ALBEDO = ((0.2, 0.7, 0.7), (0.9, 0.2, 0.9))
#: the wavefront estimator's frame with the hook on #3's plain version,
#: held to the bit against the same frame through the kernel: a small
#: shape, since the plain walk syncs the host at every step
WAVEFRONT_PLAIN = dict(width=160, height=90, spp=2, max_depth=4)
#: a wavefront image against a kernel engine's of the same scene (another
#: RNG): the mean absolute difference within this multiple of the
#: wavefront's own two-seed noise floor (tests/test_megakernel.py:97-120)
NOISE_FLOOR_MULT = 1.5
#: render_flat on the card against the same call on the CPU (the same
#: threefry draws): rows within these, on this share of the rays
WAVEFRONT_DEVICE_TOL = dict(rtol=1e-4, atol=1e-5, frac=0.99)
STEP_LR, STEP_SEEDS = 2.0, range(5)
#: the mesh step (render_flat_hybrid_grad_mesh, bench.py's mesh tier): the
#: leaves of its gradient, RGB and spectral.  Its backward through #3 is
#: held to the bit against the same replay through the plain hook: #3's
#: outputs are the plain walk's bits, so both run the same operations on
#: the same values, and the gathers' backward on the card
#: (kernels/row_gather.py) sums each row's rays in ray order, so the sums
#: do not depend on the scheduler
MESH_FIELDS = {False: (("materials", "albedo"), ("camera", "origin"),
                       ("triangles", "v0")),
               True: (("materials", "albedo_spd"),)}


def log(*args):
    print(*args, flush=True)


def device_breakdown(fn, runs=5):
    """Kernel time on the card by name over ``runs`` calls of ``fn``
    (torch.profiler), and the card's idle share of the host's window."""
    from spira_tpu_torch.bench.mesh_frame import profile_call

    p = profile_call(fn, runs)
    return dict(
        runs=runs,
        wall_ms_per_call=p["wall_ms"],
        device_ms_per_call=p["device_ms"],
        idle_share=(1.0 - p["device_ms"] / p["wall_ms"]
                    if p["kernels_ms"] else None),
        kernels_ms_per_call=p["kernels_ms"],
    )


def log_breakdown(card, what, breakdown):
    if breakdown["idle_share"] is None:
        log(f"[profile] {what}: no device time in the trace: not measured")
        return
    top = list(breakdown["kernels_ms_per_call"].items())[:4]
    log(f"[profile] {card}: {what} wrapper "
        f"{breakdown['wall_ms_per_call']:.4f} ms/call on the host, "
        f"{breakdown['device_ms_per_call']:.4f} ms/call on the card, "
        f"idle share {breakdown['idle_share']:.4f}; top kernels "
        f"(ms/call): {[(k, round(v, 5)) for k, v in top]}")


def check_images(name, kernel, plain, tol, exact=False):
    """Hold a kernel's flat HDR buffer against the plain version's: within
    ``tol``, and with ``exact`` equal to the bit."""
    if kernel.shape != plain.shape or not torch.isfinite(kernel).all():
        raise AssertionError(f"{name}: kernel output bad shape or not finite")
    bit_equal = torch.equal(kernel, plain)
    diff = (kernel - plain).abs()
    max_abs = float(diff.max())
    frac_off = float((diff > tol["atol"]).float().mean())
    km, pm = kernel.mean(0).tolist(), plain.mean(0).tolist()
    rel = max(abs(a / b - 1.0) for a, b in zip(km, pm))
    log(f"[compare] {name}: max_abs {max_abs:.3e}, "
        f"share > {tol['atol']:g}: {frac_off:.6f} "
        f"(limit {1 - tol['frac']:.4f}), channel means kernel "
        f"{[round(x, 6) for x in km]} plain {[round(x, 6) for x in pm]}, "
        f"max rel {rel:.2e} (limit {tol['mean_rel']}); bit-equal {bit_equal}"
        f"{' (required)' if exact else ''}")
    if (frac_off > 1.0 - tol["frac"] or rel > tol["mean_rel"]
            or (exact and not bit_equal)):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return dict(case=name, max_abs_err=max_abs, share_over_atol=frac_off,
                mean_rel=rel, bit_equal=bit_equal)


def compare_sphere(sp, mk, name, scene_fn, cam_fn, shape, tol, device):
    scene = getattr(sp, scene_fn)(device=device)
    w, h = shape["width"], shape["height"]
    cam = getattr(sp, cam_fn)(w / h, device=device)
    kernel = mk.render_flat_megakernel(scene, cam, seed=7, **shape)
    plain = mk.render_flat_fused(scene, cam, seed=7, **shape)
    torch.cuda.synchronize()
    return check_images(name, kernel, plain, tol, exact=True)


def random_rays(n, device, seed=0):
    """Origins in a box around the bunny; half the directions aimed at it,
    half uniform on the sphere."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-1.2, 0.0, -1.2])
    hi = torch.tensor([1.2, 1.4, 1.2])
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    d = torch.randn(n, 3, generator=g)
    d[::2] = torch.tensor([0.0, 0.45, 0.0]) - o[::2] + 0.3 * d[::2]
    d = d / d.norm(dim=1, keepdim=True)
    return o.to(device), d.to(device)


def compare_intersect(name, kernel_fn, plain_fn, o, d, exact=False):
    """A nearest-hit kernel ``kernel_fn(o, d)`` against ``plain_fn(o, d)``
    (its plain version, or another query) under the query limits, and
    with ``exact`` equal to the bit."""
    kt, kn, kmid = kernel_fn(o, d)
    pt, pn, pmid = plain_fn(o, d)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in ((kt, pt), (kn, pn),
                                                    (kmid, pmid)))
    n = o.shape[0]
    kmiss, pmiss = kt >= 1e19, pt >= 1e19
    miss_share = float((kmiss != pmiss).float().mean())
    both = ~kmiss & ~pmiss
    t_err = (kt[both] - pt[both]).abs()
    t_rel = float((t_err / pt[both].abs()).max()) if both.any() else 0.0
    mid_share = float((kmid == pmid).float().mean())
    n_share = float(((kn - pn).abs().amax(dim=1) <= NORMAL_ATOL)
                    .float().mean())
    log(f"[compare] {name}: {n} rays, {int(both.sum())} common hits, miss "
        f"sets differ on {miss_share:.2e} (limit {MISS_SHARE:g}), t max rel "
        f"{t_rel:.2e} (limit {T_RTOL:g}), mat id equal on {mid_share:.6f} "
        f"(limit {MID_SHARE}), normal within {NORMAL_ATOL:g} on "
        f"{n_share:.6f} (limit {NORMAL_SHARE}); bit-equal {bit_equal}"
        f"{' (required)' if exact else ''}")
    if not torch.isfinite(kt).all() or kn.shape != (n, 3):
        raise AssertionError(f"{name}: kernel output bad shape or not finite")
    if (miss_share > MISS_SHARE or t_rel > T_RTOL or mid_share < MID_SHARE
            or n_share < NORMAL_SHARE or (exact and not bit_equal)):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return dict(case=name, rays=n, common_hits=int(both.sum()),
                max_abs_err=float(t_err.max()) if both.any() else 0.0,
                t_max_rel=t_rel, miss_share=miss_share, mid_share=mid_share,
                normal_share=n_share, bit_equal=bit_equal)


def counters():
    """Every kernel wrapper with a launch count, by kernel name."""
    from spira_tpu_torch.bench import packet_profile, vpu_peak
    from spira_tpu_torch.kernels import (
        bvh_megakernel,
        grad_megakernel,
        megakernel,
        mxu_megakernel,
        spectral_bvh,
        spectral_fused,
    )

    return dict(
        megakernel=megakernel.render_flat_megakernel,
        bvh_megakernel=bvh_megakernel.render_flat_bvh_megakernel,
        bvh_counted=bvh_megakernel.render_bvh_with_counters,
        vpu_peak=vpu_peak.vpu_peak,
        vpu_dtype=packet_profile.vpu_dtype,
        bvh_intersect=bvh_megakernel.intersect_tile,
        spectral_megakernel=spectral_fused.render_flat_spectral_megakernel,
        spectral_bvh_megakernel=(
            spectral_bvh.render_flat_spectral_bvh_megakernel),
        grad_megakernel=grad_megakernel.render_grad_megakernel,
        grad_loss_forward=grad_megakernel.loss_forward,
        mxu_megakernel=mxu_megakernel.render_flat_mxu_megakernel,
        mxu_intersect=mxu_megakernel.intersect_tile_mxu,
        bvh_mxu_megakernel=bvh_megakernel.render_flat_bvh_mxu_megakernel,
    )


def reset_counts():
    from spira_tpu_torch.kernels import bvh_megakernel, megakernel

    from spira_tpu_torch.kernels import mxu_megakernel

    for fn in counters().values():
        fn.launches = 0
    mxu_megakernel.render_flat_mxu_megakernel.routes.update(
        dict.fromkeys(mxu_megakernel.ROUTES, 0))
    megakernel.render_flat_fused.calls = 0
    bvh_megakernel.trace_mesh.calls = 0


def counts():
    from spira_tpu_torch.kernels import bvh_megakernel, megakernel

    got = {name: fn.launches for name, fn in counters().items()}
    got["plain_tracer_calls"] = megakernel.render_flat_fused.calls
    got["plain_mesh_calls"] = bvh_megakernel.trace_mesh.calls
    return got


def count_work(module, factory, fn, stream_blocks=0, stream_lanes=0,
               block_lanes=None, block_groups=None):
    """Run ``fn()`` (a plain version) with ``module.factory``'s intersector
    counting the live path segments it is asked for and the hits among
    them, and the packed walk counting its pops, leaf triangles and
    superleaf blocks: the work a kernel does on the same inputs (the plain
    walk pops the records the kernel's walk pops, in the same order).
    ``stream_blocks`` and ``stream_lanes``: the superleaf blocks and the
    real lanes every segment tests, for the streaming kernels, which have
    no walk and test only a block's real lanes (``lanes`` in the work);
    ``block_lanes``: each block's real lanes, for a walk whose kernel
    tests only those of a block it visits; with ``block_groups`` too (the
    tree's group boxes, ``accel/mxu.py:lane_group_bounds``) also the boxes
    #2b tests first (``groups``) and the real lanes of those the ray
    enters, which it tests (``lanes_tested``)."""
    from spira_tpu_torch.accel.mxu import LANE_GROUP
    from spira_tpu_torch.kernels import bvh_megakernel as bk

    made = getattr(module, factory) if factory else None
    slab, leaf_hits, block_hits = bk._slab, bk._leaf_hits, bk._block_hits
    work = dict(segments=0, hits=0, pops=0, leaf_tris=0, blocks=0)

    def counting_slab(rec, half, *args):
        if half == 0:
            work["pops"] += rec.shape[0]
        return slab(rec, half, *args)

    def counting_leaf_hits(slots, form, max_leaf, ptr, cnt, *args):
        work["leaf_tris"] += int(cnt.sum())
        return leaf_hits(slots, form, max_leaf, ptr, cnt, *args)

    def counting_block_hits(views, ptr, *args):
        work["blocks"] += ptr.numel()
        if block_lanes is not None:
            work["lanes"] = (work.get("lanes", 0)
                             + int(block_lanes[ptr].sum()))
        if block_groups is not None:
            real = block_lanes[ptr].long()
            bk._slab = slab  # the boxes' slab tests are not pops
            try:
                enter = bk.block_hits_pruned(views, block_groups, ptr,
                                             *args)[5]
            finally:
                bk._slab = counting_slab
            lane = torch.arange(enter.shape[1] * LANE_GROUP,
                                device=ptr.device)
            work["groups"] = (work.get("groups", 0)
                              + int(((real + LANE_GROUP - 1)
                                     // LANE_GROUP).sum()))
            work["lanes_tested"] = work.get("lanes_tested", 0) + int(
                (enter.repeat_interleave(LANE_GROUP, 1)
                 & (lane[None] < real[:, None])).sum())
        return block_hits(views, ptr, *args)

    def counting(*args, **kwargs):
        intersect = made(*args, **kwargs)

        def wrapped(o3, d3, active=None):
            out = intersect(o3, d3, active)
            live = (torch.ones_like(out[0]) if active is None
                    else active.clone())
            work["segments"] += int(live.sum())
            work["hits"] += int((live & out[0]).sum())
            work["blocks"] += int(live.sum()) * stream_blocks
            if stream_lanes:
                work["lanes"] = (work.get("lanes", 0)
                                 + int(live.sum()) * stream_lanes)
            return out

        return wrapped

    if factory:
        setattr(module, factory, counting)
    bk._slab, bk._leaf_hits = counting_slab, counting_leaf_hits
    bk._block_hits = counting_block_hits
    try:
        with torch.no_grad():
            fn()
    finally:
        if factory:
            setattr(module, factory, made)
        bk._slab, bk._leaf_hits = slab, leaf_hits
        bk._block_hits = block_hits
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return work


def price(work, rates):
    """A kernel's bound for ``work`` (operations by ``sol.CLASSES`` and
    ``bytes``), priced by ``sol.lower_bound_seconds`` at ``rates``:
    bound_ms, bound_by ("bytes" or "operations"), the term that bounds it
    (alu, special or bytes), every term in ms, and the data-sheet bound
    beside it for the record."""
    from spira_tpu_torch.utils import sol

    b = sol.lower_bound_seconds(work, rates)
    return dict(bound_ms=b["bound_s"] * 1e3,
                bound_by="bytes" if b["bound_by"] == "bytes" else "operations",
                bound_term=b["bound_by"],
                bound_terms_ms={k: v * 1e3 for k, v in b["terms"].items()},
                datasheet_bound_ms=sol.datasheet_bound_seconds(work) * 1e3,
                ops=work)


def sol_bound(units, nbytes, rates):
    """:func:`price` of ``units`` of work (``sol.OPS`` names) and
    ``nbytes`` bytes."""
    from spira_tpu_torch.utils import sol

    return price(dict(sol.ops_of(units), bytes=nbytes), rates)


def sum_bounds(parts):
    """The bound of calls that run one after another: the sum of their
    bounds; ``bound_term`` and ``bound_by`` name the largest of the summed
    terms."""
    terms = {k: sum(p["bound_terms_ms"][k] for p in parts)
             for k in parts[0]["bound_terms_ms"]}
    term = max(terms, key=terms.get)
    return dict(bound_ms=sum(p["bound_ms"] for p in parts),
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bound_terms_ms=terms,
                datasheet_bound_ms=sum(p["datasheet_bound_ms"]
                                       for p in parts))


def table_bytes(*tensors):
    return sum(4 * t.numel() for t in tensors)


def coeff_bytes(tables):
    """Bytes of a superleaf packing's coefficient tables."""
    return table_bytes(tables.coeff_uv, tables.coeff_t, tables.coeff_pay)


def lane_bytes(tables):
    """Bytes the streaming kernels read of a superleaf packing: the real
    lanes' records, their offsets and the payload table."""
    lanes = tables.lanes
    return table_bytes(lanes.records, lanes.offsets, tables.coeff_pay)


def all_lanes(work):
    """``work`` priced as if every block's 128 lanes were tested (the
    TPU's contraction), for the bound beside the real-lane one."""
    return {k: v for k, v in real_lanes(work).items() if k != "lanes"}


def real_lanes(work):
    """``work`` priced at every real lane of each visited block, no
    group box tested (#2b before its groups were pruned)."""
    return {k: v for k, v in work.items()
            if k not in ("groups", "lanes_tested")}


def tested_lanes(work):
    """``work`` priced at the lanes #2b tests (``lanes_tested``: the real
    lanes of the groups entered) and the group boxes it tests first."""
    return dict(real_lanes(work), lanes=work["lanes_tested"],
                groups=work["groups"])


def rel_l2(kernel, plain):
    den = float(torch.linalg.norm(plain))
    num = float(torch.linalg.norm(kernel - plain))
    return num / den if den > 0 else num


def compare_grad(gk, mk, name, scene, cam, shape, grad_spp, loss_mode):
    """The adjoint kernel against autograd through the plain tracer, same
    tables, seed and cotangent (or target)."""
    w, h = shape["width"], shape["height"]
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    if loss_mode:
        pix = mk.render_flat_fused(scene, cam, seed=99, **shape)
    else:
        g = torch.Generator().manual_seed(5)
        pix = (torch.rand(w * h, 3, generator=g) - 0.5).to(cam.origin.device)
    kw = dict(loss_mode=loss_mode, grad_spp=grad_spp, seed=7, **shape)
    loss_k, *grads_k = gk.render_grad_megakernel(scene, cam, tables, pix,
                                                 **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss_p, *grads_p = gk.grad_tables_plain(scene, cam, tables, pix, **kw)
    end.record()
    torch.cuda.synchronize()
    out = dict(case=name, plain_ms_once=start.elapsed_time(end))
    msg = f"[compare] {name}:"
    ok = True
    if loss_mode:
        loss_rel = abs(float(loss_k) / float(loss_p) - 1.0)
        out.update(loss=float(loss_k), loss_plain=float(loss_p),
                   loss_rel=loss_rel)
        msg += (f" loss {float(loss_k):.8g} plain {float(loss_p):.8g} rel "
                f"{loss_rel:.2e} (limit {GRAD_LOSS_RTOL:g});")
        ok &= loss_rel <= GRAD_LOSS_RTOL
    max_abs = 0.0
    for table, k, p in zip(("camera", "sphere", "triangle"), grads_k,
                           grads_p):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{name}: {table} gradient not finite")
        rel = rel_l2(k, p)
        max_abs = max(max_abs, float((k - p).abs().max()) if k.numel()
                      else 0.0)
        out[f"{table}_rel_l2"] = rel
        msg += (f" {table} rel L2 {rel:.2e} (|plain| "
                f"{float(torch.linalg.norm(p)):.4g}; limit {GRAD_REL_L2:g})")
        ok &= rel <= GRAD_REL_L2
    out["max_abs_err"] = max_abs
    log(msg)
    if not ok:
        raise AssertionError(f"{name}: adjoint kernel disagrees with the "
                             f"plain autograd backward")
    return out


def check_loss_forward(gk, mk, scene, cam):
    """Loss mode's forward kernel renders what kernel #1 renders: its loss
    against the MSE of #1's image on the same target and seed, at MAIN."""
    tables = [t.detach().contiguous() for t in mk.pack_tables(scene, cam)]
    target = torch.rand(MAIN["width"] * MAIN["height"], 3,
                        generator=torch.Generator().manual_seed(3)
                        ).to(cam.origin.device)
    loss, *_ = gk.render_grad_megakernel(scene, cam, tables, target,
                                         loss_mode=True, grad_spp=4, seed=7,
                                         **MAIN)
    img = mk.render_flat_megakernel(scene, cam, seed=7, **MAIN)
    mse = float(((img.double() - target.double()) ** 2).mean())
    rel = abs(float(loss) / mse - 1.0)
    log(f"[compare] loss mode's loss {float(loss):.9g} against the MSE of "
        f"#1's image {mse:.9g}: rel {rel:.2e} (limit {LOSS_FORWARD_RTOL:g})")
    if not rel <= LOSS_FORWARD_RTOL:
        raise AssertionError("loss mode's forward disagrees with kernel #1")
    return dict(case="loss mode's loss against the MSE of #1's image, "
                "demo 640x360 spp16 d4", loss=float(loss), mse=mse,
                loss_rel=rel, max_abs_err=abs(float(loss) - mse))


def with_materials(scene, **fields):
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, **fields))


def check_finite_differences(sp, scene, cam, shape):
    """Central differences of the forward kernel (float32, eps 2e-3) on 3
    albedo and 3 emission entries against the adjoint kernel's gradient
    of the same MSE, under tests/test_grad.py's rule
    |fd - an| <= max(2e-3, 0.06 |fd|)."""
    from spira_tpu_torch.kernels import megakernel as mk

    target = torch.full((shape["width"] * shape["height"], 3), 0.25,
                        device=cam.origin.device)
    albedo = scene.materials.albedo.clone().requires_grad_()
    emission = scene.materials.emission.clone().requires_grad_()
    img = sp.render_flat_hybrid_grad(
        with_materials(scene, albedo=albedo, emission=emission), cam,
        seed=3, **shape)
    ((img - target) ** 2).mean().backward()

    def loss(**fields):
        img = mk.render_flat_megakernel(with_materials(scene, **fields), cam,
                                        seed=3, **shape)
        return float(((img - target) ** 2).mean())

    rs = np.random.default_rng(0)
    eps, checks = 2e-3, []
    for name, grad in (("albedo", albedo.grad), ("emission", emission.grad)):
        base = getattr(scene.materials, name)
        for _ in range(3):
            i, j = int(rs.integers(base.shape[0])), int(rs.integers(3))
            probes = []
            for sign in (1.0, -1.0):
                p = base.clone()
                p[i, j] += sign * eps
                probes.append(loss(**{name: p}))
            fd = (probes[0] - probes[1]) / (2 * eps)
            an = float(grad[i, j])
            limit = max(2e-3, 0.06 * abs(fd))
            log(f"[fd] {name}[{i},{j}]: central difference {fd:.6f}, "
                f"adjoint {an:.6f}, |gap| {abs(fd - an):.2e} (limit "
                f"{limit:.2e})")
            if abs(fd - an) > limit:
                raise AssertionError(f"{name}[{i},{j}]: gradient disagrees "
                                     f"with central differences")
            checks.append(dict(entry=f"{name}[{i},{j}]", fd=fd, adjoint=an))
    return checks


def dispersive_mesh(sp, device):
    """A packed scene with a dispersive sphere in view: a 20-triangle
    icosphere over a ground sphere, a light, and flint-like glass
    (cauchy_b 0.01) on the specular lobe."""
    from spira_tpu_torch.accel.bvh import build_bvh_for_triangles
    from spira_tpu_torch.scene.obj import icosphere

    mesh = icosphere(center=(0.0, 0.3, 0.0), radius=0.6, subdivisions=0,
                     material=0)
    materials = sp.make_materials([
        dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
        dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
        dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0, ior=1.5,
             transmission=1.0, cauchy_b=0.01),
    ], device="cpu")
    spheres = sp.make_spheres([((0.0, -100.5, 0.0), 100.0, 1),
                               ((0.0, 5.0, 0.0), 1.0, 2),
                               ((0.9, 0.0, 0.6), 0.35, 3)], device="cpu")
    scene = sp.make_scene(spheres=spheres, triangles=mesh,
                          materials=materials,
                          bvh=build_bvh_for_triangles(mesh))
    return sp.attach_packed(scene).to(device)


def check_main(what, kernel, img, plain_img, got, png):
    """A main path's image: ``kernel`` launched, the image not empty, and
    its uint8 mean within one level of the plain version's at the same
    spp (a noisier image sits lower after the concave tone map)."""
    gap = abs(float(img.mean()) - float(plain_img.mean()))
    log(f"[main] {what}: image {img.shape} {img.dtype}, mean "
        f"{img.mean():.4f} (plain {plain_img.mean():.4f}), std "
        f"{img.std():.4f}, png {os.path.getsize(png)} bytes, launches {got}")
    if got[kernel] < 1:
        raise AssertionError(f"{what} did not launch {kernel}")
    if img.ndim != 3 or img.shape[2] != 3 or img.std() == 0:
        raise AssertionError(f"{what}: image is empty or constant")
    if gap > 1.0:
        raise AssertionError(f"{what}: uint8 means differ by {gap} > 1")


def check_wavefront_hook(sp, bk, scene, cam):
    """render_flat's frame, every bounce's nearest hits from kernel #3,
    against the same frame with the hook on #3's plain version on the
    card, to the bit (the same threefry draws and tensor operations)."""
    from spira_tpu_torch.render import wavefront_mean

    shape = WAVEFRONT_PLAIN
    kernel = sp.render_flat(scene, cam, seed=3, **shape)
    plain = wavefront_mean(scene, cam, bk.make_sorted_tile_intersect(
        grad=True, query=bk.intersect_packed_plain), seed=3, **shape)
    torch.cuda.synchronize()
    return check_images(
        f"wavefront bunny {shape['width']}x{shape['height']} spp"
        f"{shape['spp']} d{shape['max_depth']}: #3 hook against the plain "
        "hook", kernel, plain, BVH_TOL, exact=True)


def check_wavefront_rays(bk, ib, scene, cam):
    """#3 in the mode and at the shape the main path gives it: every
    bounce of the main path's first sample (``render_flat`` of ``MAIN``
    at its default seed, whose hook asks for the slot and hands over a
    partly dead ``active``), recorded by ``bench/intersect_bounces.py``
    from a spp-1 frame of the same key, each launch's t, normal, mat id
    and slot against the plain walk's on the same tensors, to the bit.
    Returns the checks and the recorded calls."""
    calls = ib.record_bounces(scene, cam, MAIN)
    checks = []
    for bounce, (o, d, active, got) in enumerate(calls):
        want = bk.intersect_packed_plain(scene.packed, o, d, active, True)
        torch.cuda.synchronize()
        name = (f"#3 on render_flat's bounce {bounce} rays, bunny "
                f"{MAIN_SHAPE} sample 0")
        alive = float(active.float().mean())
        hits = float((got[0] < 1e19).float().mean())
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        log(f"[compare] {name}: {o.shape[0]} rays, alive {alive:.6f}, hits "
            f"{hits:.6f}, with_slot True; t, normal, mat id, slot "
            f"bit-equal to the plain walk: {equal} (required)")
        if len(got) != 4 or not all(equal):
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 "walk")
        checks.append(dict(case=name, rays=o.shape[0], alive_share=alive,
                           hit_share=hits, bit_equal=True, max_abs_err=err))
    if not 0.0 < checks[-1]["alive_share"] < 1.0:
        raise AssertionError("the last bounce's rays are all alive or all "
                             "dead: the check does not see the active mask")
    return checks, calls


def check_noise_floor(name, wave, wave_other_seed, engine_img):
    """A kernel engine's image against the wavefront's (another RNG): the
    mean absolute difference within NOISE_FLOOR_MULT x the wavefront's
    own two-seed noise floor."""
    for img in (wave, wave_other_seed, engine_img):
        if img.shape != wave.shape or not torch.isfinite(img).all():
            raise AssertionError(f"{name}: bad shape or not finite")
    floor = float((wave - wave_other_seed).abs().mean())
    gap = float((engine_img - wave).abs().mean())
    log(f"[compare] {name}: mean abs difference {gap:.6f}, wavefront "
        f"two-seed noise floor {floor:.6f}, ratio {gap / floor:.4f} (limit "
        f"{NOISE_FLOOR_MULT}); channel means wavefront "
        f"{[round(x, 5) for x in wave.mean(0).tolist()]}, engine "
        f"{[round(x, 5) for x in engine_img.mean(0).tolist()]}")
    if not 0.0 < floor or gap > NOISE_FLOOR_MULT * floor:
        raise AssertionError(f"{name}: the images disagree beyond the "
                             "noise floor")
    return dict(case=name, mean_abs_diff=gap, noise_floor=floor,
                ratio=gap / floor)


def check_wavefront_device(sp, scene, cam, name, **kw):
    """render_flat on the card against the same call on the CPU."""
    got = sp.render_flat(scene, cam, **kw)
    want = sp.render_flat(scene.to("cpu"), cam.to("cpu"), **kw)
    got = got.cpu()
    tol = WAVEFRONT_DEVICE_TOL
    close = float(torch.isclose(got, want, rtol=tol["rtol"],
                                atol=tol["atol"]).all(-1).float().mean())
    max_abs = float((got - want).abs().max())
    log(f"[compare] {name}: card against CPU, rows within rtol "
        f"{tol['rtol']:g} / atol {tol['atol']:g}: {close:.6f} (limit "
        f"{tol['frac']}), max_abs {max_abs:.3e}")
    if not torch.isfinite(got).all() or close < tol["frac"]:
        raise AssertionError(f"{name}: the card's render disagrees with "
                             "the CPU's")
    return dict(case=name, share_close=close, max_abs_err=max_abs)


def check_mesh_backward(sp, bk, gs, scene, cam, spectral):
    """The mesh step's backward (#3 in the hook) at WAVEFRONT_PLAIN's
    shape against the same replay's vector-Jacobian product with the hook
    over #3's plain version, the same cotangent (``img.mean()``'s)."""
    fields = MESH_FIELDS[spectral]
    shape = WAVEFRONT_PLAIN
    _, img, got = gs.mesh_step(sp, scene, cam, seed=3, spectral=spectral,
                               shape=shape, fields=fields)
    cot = torch.full_like(img, 1.0 / img.numel())
    want = gs.mesh_replay_grads(scene, cam, cot, fields, seed=3,
                                spectral=spectral, shape=shape,
                                query=bk.intersect_packed_plain)
    torch.cuda.synchronize()
    name = (f"mesh step backward bunny {shape['width']}x{shape['height']} "
            f"spp{shape['spp']} d{shape['max_depth']} grad_spp "
            f"{gs.MESH_GRAD_SPP}{' spectral' * spectral}: #3 hook against the "
            "plain hook")
    rel = {f"{g}.{f}": rel_l2(got[g, f], want[g, f]) for g, f in fields}
    err = {f"{g}.{f}": float((got[g, f] - want[g, f]).abs().max())
           for g, f in fields}
    ok = all(torch.isfinite(got[k]).all() and float(want[k].abs().max()) > 0
             for k in fields)
    same = all(torch.equal(got[k], want[k]) for k in fields)
    log(f"[compare] {name}: bit-equal {same} (required), relative L2 a "
        f"field {rel}, max abs {err}, finite and nonzero {ok}")
    if not ok or not same:
        raise AssertionError(f"{name}: the gradients disagree")
    return dict(case=name, bit_equal=same, rel_l2=rel,
                max_abs_err=max(err.values()))


def check_peak(vp, x, outs, where):
    """Kernel #9's outputs ``{mode: output}`` on ``x`` against its plain
    version on the same input: separate bit-equal, contracted within
    PEAK_FMA_ULP, the special functions within PEAK_SPECIAL_RTOL."""
    checks = []
    for mode, k in outs.items():
        p = vp.peak_plain(x, mode)
        torch.cuda.synchronize()
        if k.shape != p.shape or not torch.isfinite(k).all():
            raise AssertionError(f"#9 {mode} {where}: bad shape or not "
                                 f"finite")
        diff = (k - p).abs()
        rel = float((diff / p.abs().clamp(min=1e-30)).max())
        same = torch.equal(k, p)
        if mode == "separate":
            ok, limit = same, "bit-equal"
        elif mode == "contracted":
            # the chains' sums are positive: float32 bit patterns order them
            ulp = int((k.view(torch.int32) - p.view(torch.int32)).abs().max())
            ok, limit = ulp <= PEAK_FMA_ULP, f"{PEAK_FMA_ULP} ulp (got {ulp})"
        else:
            ok, limit = rel <= PEAK_SPECIAL_RTOL, f"rel {PEAK_SPECIAL_RTOL:g}"
        log(f"[compare] #9 {mode} {where}: max abs {float(diff.max()):.3e}, "
            f"max rel {rel:.3e}, bit-equal {same} (limit {limit})")
        if not ok:
            raise AssertionError(f"#9 {mode} {where}: kernel disagrees with "
                                 f"plain")
        checks.append(dict(case=f"#9 {mode} {where}",
                           max_abs_err=float(diff.max()), max_rel_err=rel,
                           bit_equal=same))
    return checks


def check_dtype(pp, x, outs, where):
    """Kernel #10's outputs ``{dtype: output}`` on ``x`` against its plain
    version on the same input: bit-equal (one rounding to the type per
    operation on both sides)."""
    checks = []
    for dtype, k in outs.items():
        p = pp.vpu_dtype_plain(x, dtype)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        max_abs = float((k - p).abs().max())
        log(f"[compare] #10 {dtype} {where}: max abs {max_abs:.3e}, "
            f"bit-equal {same} (limit bit-equal); first value "
            f"{float(k[0]):.8g}")
        if not same or not torch.isfinite(k).all():
            raise AssertionError(f"#10 {dtype} {where}: kernel disagrees "
                                 f"with plain")
        checks.append(dict(case=f"#10 {dtype} {where}", max_abs_err=max_abs,
                           bit_equal=same))
    return checks


def check_probes_jax_shapes(vp, pp, device):
    """Both probes at the JAX shapes, on the JAX probes' inputs (#9: a
    (32, 128) tile of ones; #10: a (256, 128) tile of 0.5) and on an input
    that varies by element."""
    n9, n10 = int(np.prod(vp.JAX_SHAPE)), pp.ROWS * pp.COLS
    checks = []
    for what, x in (("ones", torch.ones(n9, device=device)),
                    ("varied", vp.probe_input(n9, device, seed=1))):
        checks += check_peak(vp, x, {m: vp.vpu_peak(x, m) for m in vp.MODES},
                             f"{vp.JAX_SHAPE} {what}")
    for what, x in (("0.5", torch.full((n10,), 0.5, device=device)),
                    ("varied", vp.probe_input(n10, device, seed=1))):
        checks += check_dtype(pp, x, {d: pp.vpu_dtype(x, d)
                                      for d in pp.DTYPES},
                              f"({pp.ROWS}, {pp.COLS}) {what}")
    return checks


def check_counted(bk, scene, cam):
    """The counting build of #2 on ``scene``: its image bit-equal to the
    uncounted kernel's at MAIN, its totals at BVH_TIMED equal to the plain
    counting walk's, its image there held against the plain version's,
    and pops == traversals + pushes."""
    img, ctr = bk.render_bvh_with_counters(scene, cam, **MAIN)
    ref = bk.render_flat_bvh_megakernel(scene, cam, **MAIN)
    torch.cuda.synchronize()
    same = torch.equal(img, ref)
    log(f"[compare] #2 counting build 640x360 spp16 d4 against the "
        f"uncounted kernel: bit-equal {same}; counters {ctr}")
    if not same:
        raise AssertionError("#2: the counting build's image differs")
    img4, ctr4 = bk.render_bvh_with_counters(scene, cam, **BVH_TIMED)
    plain_img, plain_counts = bk.render_bvh_counters_fused(scene, cam,
                                                           **BVH_TIMED)
    torch.cuda.synchronize()
    plain = {k: int(v.sum()) for k, v in plain_counts.items()}
    log(f"[compare] #2 counting build 640x360 spp4 d4: kernel {ctr4}, plain "
        f"walk {plain}")
    if ctr4 != plain:
        raise AssertionError("#2: the counting kernel's totals differ from "
                             "the plain walk's")
    for c in (ctr, ctr4):
        if c["pops"] != c["traversals"] + c["pushes"]:
            raise AssertionError(f"#2: pops != traversals + pushes in {c}")
    check = check_images("#2 counting build 640x360 spp4 d4", img4,
                         plain_img, BVH_TOL, exact=True)
    return dict(counters_640x360_spp16_d4=ctr, counters_640x360_spp4_d4=ctr4,
                image_bit_equal_uncounted=same, **check)


#: the command line's phase: the demo preset (640x360, depth 4) at spp 16
CLI_ARGS = ("--preset", "demo", "--spp", "16", "--seed", "0")
#: cli render's four kernel paths: (label, scene, spectral, kernel)
CLI_RENDERS = (("cli_render_default", "default", False, "megakernel"),
               ("cli_render_bunny", "bunny", False, "bvh_megakernel"),
               ("cli_render_cornell_spectral", "cornell", True,
                "spectral_megakernel"),
               ("cli_render_bunny_spectral", "bunny", True,
                "spectral_bvh_megakernel"))


def read_png(path):
    """An 8-bit RGB PNG the port wrote, as an (H, W, 3) uint8 array."""
    from spira_tpu_torch.io.image import load_png

    return load_png(path)


class _Records:
    """The port's log records (``spira_tpu_torch``) while in the block,
    with the structured fields the command line attaches to them."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.records.append(record)

        self.records = []
        self.handler = Handler()
        logging.getLogger("spira_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("spira_tpu_torch").removeHandler(self.handler)
        return False

    def field(self, name):
        return [getattr(r, name) for r in self.records if hasattr(r, name)]


def nonzero(got):
    """The launch counts that are not 0."""
    return {k: v for k, v in got.items() if v}


def check_only(label, got, kernel, n=None):
    """``got`` (launch counts) has ``n`` launches of ``kernel`` (at least
    one when ``n`` is None) and none of anything else."""
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others or got[kernel] < 1 or (n is not None and got[kernel] != n):
        raise AssertionError(f"{label}: launches {got}, wanted "
                             f"{n or '> 0'} of {kernel} and nothing else")


def cli_phase(sp, bk, out_dir, work_dir, main_runs, device="cuda",
              size=(640, 360)):
    """Phase 3b: the command line through ``cli.main``, each path with the
    launch counts set to 0 just before it and read just after.  The PNGs
    go into ``out_dir``, the checkpoints into ``work_dir`` (fresh each
    run, so no path resumes from an earlier run's).  Returns {kernel
    name: {cli label: what the path measured}} for the kernels line (the
    paths that launch no kernel are logged only).  ``device`` and
    ``size`` (the demo preset's by default) rehearse the phase
    elsewhere."""
    import contextlib
    import io as io_mod

    from spira_tpu_torch import cli, pipeline
    from spira_tpu_torch.diff import inverse
    from spira_tpu_torch.utils.metrics import sync_device
    from spira_tpu_torch.integrator.preview import render_flat_preview
    from spira_tpu_torch.io import image as img_io
    from spira_tpu_torch.utils import checkpoint as ckpt
    from spira_tpu_torch.utils import config

    paths = {}
    w, h = size
    cli_args = [*CLI_ARGS, "--width", str(w), "--height", str(h),
                "--device", device]

    def run(label, argv, main_path=True):
        """cli.main(argv): (records, launches, wall ms); the launches are
        one call of a main path unless ``main_path`` is False."""
        with _Records() as rec:
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            sync_device()
            wall = 1e3 * (time.perf_counter() - t0)
            got = counts()
        if rc != 0:
            raise AssertionError(f"{label}: cli.main returned {rc}")
        if main_path:
            main_runs[label] = got
        return rec, got, wall

    def reference(scene_name, spectral=False):
        cfg = config.RenderConfig(scene=scene_name, spectral=spectral,
                                  width=w, height=h, spp=16, max_depth=4,
                                  device=device)
        return config.build_scene(cfg)

    # 1. cli render on the four kernel paths: one launch, render_hdr's
    # image to the bit
    for label, scene_name, spectral, kernel in CLI_RENDERS:
        png = os.path.join(out_dir, f"{label}.png")
        argv = ["render", "--scene", scene_name, *cli_args, "-o", png]
        rec, got, wall = run(label, argv + ["--spectral"] * spectral)
        check_only(label, got, kernel, 1)
        scene, cam = reference(scene_name, spectral)
        want = img_io.to_uint8(img_io.tonemap_gamma(sp.render_hdr(
            scene, cam, w, h, spp=16, max_depth=4, seed=0,
            spectral=spectral)))
        same = bool(np.array_equal(read_png(png), want))
        seconds = rec.field("render_seconds")[0]
        rays = w * h * 16 * 4
        info = dict(launches=got[kernel], wall_ms=wall,
                    render_ms=1e3 * seconds,
                    mrays_per_s=rays / seconds / 1e6,
                    png_equals_render_hdr=same)
        log(f"[cli] {label}: {' '.join(argv[1:])}{' --spectral' * spectral}"
            f": launches {nonzero(got)}, wall {wall:.1f} ms, run_config "
            f"{1e3 * seconds:.1f} ms, {info['mrays_per_s']:.1f} Mrays/s; "
            f"PNG equal to render_hdr's tone-mapped image to the bit: "
            f"{same}")
        if not same:
            raise AssertionError(f"{label}: PNG differs from render_hdr's")
        paths.setdefault(kernel, {})[label] = info

    # 2. the adaptive renderer on the bunny (block granularity): #3 only,
    # the same image twice
    label = "cli_render_adaptive_bunny"
    pngs, runs = [], []
    for i in range(2):
        pngs.append(os.path.join(out_dir, f"{label}_{i}.png"))
        runs.append(run(label, ["render", "--scene", "bunny", *cli_args,
                                "--adaptive-tol", "0.05", "-o", pngs[-1]]))
    rec, got, wall = runs[0]
    check_only(label, got, "bvh_intersect")
    stats = rec.field("adaptive_stats")[0]
    same = bool(np.array_equal(read_png(pngs[0]), read_png(pngs[1])))
    info = dict(launches=got["bvh_intersect"], wall_ms=wall,
                wall_ms_second_run=runs[1][2], rounds=stats["rounds"],
                host_syncs=stats["host_syncs"],
                total_samples=stats["total_samples"],
                uniform_samples=stats["uniform_samples"],
                samples_saved=(stats["uniform_samples"]
                               - stats["total_samples"]),
                savings=stats["savings"], deterministic=same)
    log(f"[cli] {label}: --adaptive-tol 0.05 (block granularity, min spp "
        f"8, cap 16): launches {nonzero(got)}, wall {wall:.1f} and "
        f"{runs[1][2]:.1f} ms, {stats['total_samples']} samples of a "
        f"uniform {stats['uniform_samples']} ({info['samples_saved']} saved,"
        f" {100 * stats['savings']:.1f}%), {stats['rounds']} rounds, "
        f"{stats['host_syncs']} host syncs; the same image twice: {same}")
    if not same or runs[1][1] != got:
        raise AssertionError(f"{label}: not deterministic")
    paths.setdefault("bvh_intersect", {})[label] = info

    # 3. the previews on the bunny: one #3 launch each; the image the
    # preview through #3's hook, equal to the preview through #3's plain
    # version to the bit (both recompute the winning hit alike)
    scene, cam = reference("bunny")
    for shading in ("preview", "normal"):
        label = f"cli_render_{shading}_bunny"
        png = os.path.join(out_dir, f"{label}.png")
        rec, got, wall = run(label, ["render", "--scene", "bunny",
                                     *cli_args, "--shading", shading, "-o",
                                     png])
        check_only(label, got, "bvh_intersect", 1)
        kw = dict(width=w, height=h, seed=0, shading=shading)
        hooked = render_flat_preview(scene, cam, **kw)
        plain = render_flat_preview(
            scene, cam, intersect_fn=bk.make_sorted_tile_intersect(
                query=bk.intersect_packed_plain), **kw)
        equal = bool(torch.equal(hooked, plain))
        same = bool(np.array_equal(read_png(png), img_io.to_uint8(
            img_io.tonemap_gamma(img_io.assemble_image(hooked, w, h)))))
        err = float((hooked - plain).abs().max())
        info = dict(launches=got["bvh_intersect"], wall_ms=wall,
                    equals_plain=equal, max_abs_err=err,
                    png_equals_preview=same)
        log(f"[cli] {label}: --shading {shading}: launches "
            f"{nonzero(got)}, wall {wall:.1f} ms; equal to the plain hook's "
            f"preview to the bit: {equal} (max abs {err:.3g}); PNG the "
            f"preview's to the bit: {same}")
        if not equal or not same:
            raise AssertionError(f"{label}: preview disagrees")
        paths.setdefault("bvh_intersect", {})[label] = info

    # 4. the progressive renderer on the sphere demo: stopped after 8 of
    # 16 samples (the third chunk raises), resumed, equal to the
    # uninterrupted run to the bit
    label = "cli_render_progressive_default"
    ckdir = os.path.join(work_dir, "progressive_ck")
    argv = ["render", "--scene", "default", *cli_args, "--checkpoint-dir",
            ckdir, "--checkpoint-every", "4"]
    chunk, calls = pipeline._render_chunk, []

    def preempted(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise InterruptedError("preempted after 8 samples")
        return chunk(*a, **k)

    resumed_png = os.path.join(out_dir, f"{label}_resumed.png")
    pipeline._render_chunk = preempted
    try:
        cli.main(argv + ["-o", resumed_png])
        raise AssertionError(f"{label}: the preempted run did not stop")
    except InterruptedError:
        pass
    finally:
        pipeline._render_chunk = chunk
    saved = ckpt.load_render_state(ckdir)[1]
    # the same command again resumes from the checkpoint
    rec, got, wall = run(label, argv + ["-o", resumed_png])
    resumed_at = rec.field("resumed_samples")
    whole_png = os.path.join(out_dir, f"{label}_whole.png")
    _, _, wall_whole = run(label + "_whole", [
        "render", "--scene", "default", *cli_args, "--checkpoint-dir",
        os.path.join(work_dir, "progressive_whole"), "--checkpoint-every",
        "4", "-o", whole_png])
    same = bool(np.array_equal(read_png(resumed_png), read_png(whole_png)))
    scene, cam = reference("default")
    one_shot = bool(np.array_equal(read_png(whole_png), img_io.to_uint8(
        img_io.tonemap_gamma(sp.render_hdr(scene, cam, w, h, spp=16,
                                           max_depth=4,
                                           engine="wavefront")))))
    log(f"[cli] {label}: {' '.join(argv[1:])}: stopped in the third chunk, "
        f"the checkpoint holds {saved} samples, the same command resumed "
        f"at {resumed_at}; the resumed 8 samples "
        f"{wall:.1f} ms, the whole 16 {wall_whole:.1f} ms; launches "
        f"{nonzero(got)} (the wavefront over spheres launches no kernel); "
        f"the resumed image"
        f" equals the uninterrupted one to the bit: {same}; and the one-shot"
        f" wavefront render's: {one_shot}")
    if (saved != 8 or resumed_at != [8] or not same or not one_shot
            or any(got.values())):
        raise AssertionError(f"{label}: resume not exact")

    # 5. the inverse loop: 3 steps at spp 4 on the sphere demo (the
    # wavefront's autograd) and on the bunny (#3's slot form); the main
    # path is one step call, counted apart from the target's render
    make_step, step_runs = inverse.make_inverse_step, []

    def counting_make_step(*a, **k):
        step, init = make_step(*a, **k)

        def counted(*sa, **sk):
            before = counts()
            out = step(*sa, **sk)
            step_runs.append({n: v - before[n] for n, v in counts().items()})
            return out
        return counted, init

    for scene_name in ("default", "bunny"):
        label = f"cli_inverse_{scene_name}"
        ckdir = os.path.join(work_dir, f"{label}_ck")
        step_runs.clear()
        inverse.make_inverse_step = counting_make_step
        try:
            rec, got, wall = run(label, [
                "inverse", "--scene", scene_name, *cli_args, "--spp", "4",
                "--steps", "3", "--no-progress", "--checkpoint-dir", ckdir,
                "--checkpoint-every", "1", "-o", ""], main_path=False)
        finally:
            inverse.make_inverse_step = make_step
        if len(step_runs) != 3 or any(r != step_runs[0] for r in step_runs):
            raise AssertionError(f"{label}: step launches {step_runs}")
        main_runs[f"{label}: one step"] = step_runs[0]
        losses = rec.field("loss")
        stats = rec.field("inverse_stats")[0]
        albedo = np.load(os.path.join(ckdir, "arrays.npz"))["params:albedo"]
        moved = float(np.abs(albedo - 0.5).max())
        info = dict(launches=got["bvh_intersect"],
                    launches_per_step=step_runs[0]["bvh_intersect"],
                    wall_ms=wall, ms_per_step=1e3 * stats["seconds"] / stats["steps"],
                    peak_mib=stats["peak_mib"], losses=losses,
                    albedo_moved=moved)
        peak = ("not measured" if stats["peak_mib"] is None
                else f"{stats['peak_mib']:.1f} MiB")
        log(f"[cli] {label}: 3 steps at {w}x{h} spp4 d4: losses "
            f"{[round(x, 6) for x in losses]}, {info['ms_per_step']:.1f} ms "
            f"a step, peak memory {peak}, the albedo "
            f"moved by up to {moved:.4f}; launches {nonzero(got)} (the "
            f"target's render and the steps), a step "
            f"{nonzero(step_runs[0])}; wall {wall:.1f} ms")
        if (len(losses) != 3 or not np.isfinite(losses).all()
                or not moved > 0):
            raise AssertionError(f"{label}: bad loss or no update")
        if scene_name == "bunny":
            check_only(label, got, "bvh_intersect")
            paths.setdefault("bvh_intersect", {})[label] = info
        elif any(got.values()):
            raise AssertionError(f"{label}: launched {got}")

    # 6. info names the card
    buf = io_mod.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["info"])
    text = buf.getvalue()
    log(f"[cli] cli_info: {' | '.join(text.splitlines())}")
    if rc != 0 or torch.cuda.get_device_name(0) not in text:
        raise AssertionError("cli info does not name the card")
    return paths



#: phase 3c: the offsets #2 and #2b are held at, and the shapes of the
#: 4x1 split held to the bit against the unsharded #2 frame (BASELINE
#: config 5's 1920x1080 spp256 among them)
SHARD_OFFSETS = dict(n_rows=90, row_start=90, sample_offset=8, spp=4,
                     max_depth=4)
SPLIT_SHAPES = (MAIN, dict(width=1920, height=1080, spp=256, max_depth=4))
#: the worlds of ranks phase 3c starts, each rank a process of
#: spira_tpu_torch/bench/sharded_world.py: (job, ranks)
WORLDS = (("gloo2", 2), ("nccl1", 1))
WORLD_TIMEOUT = 300


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_world(job, n, work_dir):
    """Start ``n`` ranks of ``bench/sharded_world.py --job job`` on this
    card (each ``LOCAL_RANK`` 0, a ``localhost`` rendezvous on a free
    port), wait for them, and return each rank's JSON; a rank that fails
    or a world past WORLD_TIMEOUT kills the rest and raises."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs, outs, logs = [], [], []
    for rank in range(n):
        out = os.path.join(work_dir, f"{job}_rank{rank}.json")
        logs.append(open(os.path.join(work_dir, f"{job}_rank{rank}.log"),
                         "w+"))
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=here)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "spira_tpu_torch.bench.sharded_world",
             "--job", job, "--out", out, "--work", work_dir],
            cwd=here, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        outs.append(out)
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for rank, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines()[-40:]:
                log(f"[sharded] {job} rank {rank}: {line}")
            f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"the {job} world failed: exit codes "
                             f"{[p.returncode for p in procs]}")
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def sharded_phase(sp, bk, scenes, main_runs, work_dir):
    """Phase 3c: kernel #2 (and #2b's route) at a row and sample offset
    against its plain version to the bit, the 4x1 split of the bunny's
    frame against the unsharded #2 frame to the bit, then a 2-rank gloo
    world and a 1-rank NCCL world on this card
    (``spira_tpu_torch/bench/sharded_world.py``).  Each rank's sharded
    paths go into ``main_runs`` (launch counts of one rank's call).
    Returns {kernel name: {path: what it measured}} for the kernels
    line, and the offset checks by kernel."""
    from spira_tpu_torch.kernels.megakernel import true_divide

    bunny, cam = scenes["bunny"]
    bunny_sl = scenes["bunny_sl"][0]
    w, h = MAIN["width"], MAIN["height"]
    checks = {}
    for kernel, scene, mxu in (("bvh_megakernel", bunny, False),
                               ("bvh_mxu_megakernel", bunny_sl, True)):
        kw = dict(width=w, height=h, seed=0, mxu_leaf=mxu, **SHARD_OFFSETS)
        got = bk.bvh_rows(scene, cam, **kw)
        rows = tuple(kw.pop(k) for k in ("n_rows", "row_start",
                                         "sample_offset"))
        want = bk.render_flat_bvh_fused(scene, cam, rows=rows,
                                        normalize=False, **kw)
        torch.cuda.synchronize()
        checks[kernel] = check_images(
            f"{kernel} bvh_rows rows {rows[1]}-{rows[1] + rows[0] - 1} "
            f"samples {rows[2]}-{rows[2] + kw['spp'] - 1} of {w}x{h} "
            f"d{kw['max_depth']} "
            "against its plain version", got, want, BVH_TOL, exact=True)
    splits = []
    for shape in SPLIT_SHAPES:
        sw, sh = shape["width"], shape["height"]
        scam = sp.bunny_camera(sw / sh, device=cam.origin.device)
        frame = bk.render_flat_bvh_megakernel(bunny, scam, **shape)
        rest = {k: v for k, v in shape.items() if k != "height"}
        t0 = time.perf_counter()
        tiles = [bk.bvh_rows(bunny, scam, height=sh, n_rows=sh // 4,
                             row_start=t * sh // 4, sample_offset=0,
                             seed=0, **rest) for t in range(4)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        same = torch.equal(true_divide(torch.cat(tiles),
                                       float(shape["spp"])), frame)
        name = f"{sw}x{sh} spp{shape['spp']} d{shape['max_depth']}"
        log(f"[sharded] bunny {name}: the 4x1 split of bvh_rows (4 launches"
            f", {ms:.2f} ms on the host's clock) equal to the unsharded #2 "
            f"frame to the bit: {same}")
        if not same:
            raise AssertionError(f"the 4x1 split of {name} differs from "
                                 "the unsharded frame")
        splits.append(dict(shape=name, bit_equal=same, four_launches_ms=ms))
    worlds = {job: run_world(job, n, work_dir) for job, n in WORLDS}
    paths = {"bvh_megakernel": {"4x1 split of bvh_rows": splits}}
    zero = dict.fromkeys(counts(), 0)
    for job, ranks in worlds.items():
        for out in ranks:
            for label, row in out["rows"].items():
                got = row.get("launches")
                where = f"{job} rank {out['rank']}: {label}"
                log(f"[sharded] {out['card']}: {where}: "
                    + ", ".join(f"{k} {v}" for k, v in row.items()))
                if got is None:
                    continue
                main_runs[f"sharded {where}"] = dict(zero, **got)
                for kernel in ("bvh_megakernel", "bvh_intersect"):
                    if got.get(kernel):
                        paths.setdefault(kernel, {})[where] = row
    return paths, checks


#: the SBVH's nearest hits against the SAH tree's on the same rays: the
#: hit sets and material ids equal; t within SBVH_T_RTOL, where the hit is
#: another duplicate of the same triangle, or another triangle of an edge
#: two triangles tie on (the walks visit them in another order)
SBVH_T_RTOL = 1e-6
#: the bunny's leaf size (scene/bunny.py: create_bunny_scene)
SBVH_LEAF = 8


def compare_hits(name, got, ref):
    """#3's outputs over the SBVH against the SAH tree's on the same rays
    (t, normal, mat id, slot each): the hit set and material ids equal, t
    within SBVH_T_RTOL; the share whose slot names the same triangle."""
    hit, s_hit = ref[0] < 1e19, got[0] < 1e19
    same_set = torch.equal(hit, s_hit)
    same_mid = torch.equal(got[2], ref[2])
    t_rel = (float(((got[0] - ref[0]).abs() / ref[0].abs())[hit].max())
             if hit.any() else 0.0)
    log(f"[sbvh] {name}: {got[0].shape[0]} rays, {int(hit.sum())} hits; "
        f"hit set equal to the SAH tree's {same_set}, mat ids equal "
        f"{same_mid}, t max rel {t_rel:.3e} (limit {SBVH_T_RTOL:g})")
    if not (same_set and same_mid and t_rel <= SBVH_T_RTOL):
        raise AssertionError(f"{name}: the SBVH's nearest hits differ from "
                             "the SAH tree's")
    return dict(case=name, rays=got[0].shape[0], hits=int(hit.sum()),
                t_max_rel=t_rel, max_abs_err=float(
                    (got[0] - ref[0]).abs()[hit].max()) if hit.any() else 0.0)


def sbvh_phase(sp, bk, sb, card, bunny, bunny_cam, rays, bounce_calls,
               main_runs):
    """Phase 3d: the 72,960-triangle bunny over an SBVH (spatial splits,
    duplicated references) at the bunny's leaf size, packed: #2 at MAIN
    and #5 at BVH_TIMED bit-equal to their plain versions, #3 on the
    primary rays and on render_flat's four recorded calls of a sample
    against the SAH tree's nearest hits, the SBVH's renders through
    ``render`` and ``render_flat``, the walk's counted work, and #2, #3
    and #5 timed beside the SAH tree on the same calls (``[sbvh]``
    lines).  Returns the checks and times by kernel."""
    from spira_tpu_torch.accel.bvh import build_sbvh_for_triangles
    from spira_tpu_torch.bench.timing import cuda_ms as time_ms

    device = bunny.packed.pairs.device
    host = bunny.to("cpu")
    n = host.triangles.count
    t0 = time.perf_counter()
    tree = build_sbvh_for_triangles(host.triangles, leaf_size=SBVH_LEAF)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = sp.attach_packed(dataclasses.replace(host, bvh=tree,
                                                 packed=None)).to(device)
    t_pack = time.perf_counter() - t0
    refs = tree.prim_idx.shape[0]
    log(f"[sbvh] {card}: bunny {n} triangles, SBVH leaf {SBVH_LEAF}: build "
        f"{t_build:.3f} s, pack {t_pack:.3f} s; references {refs} "
        f"(len(prim_idx)/n {refs / n:.4f}), nodes {tree.node_count} (SAH "
        f"two-level tree {bunny.bvh.node_count}), max leaf {tree.max_leaf}, "
        f"pair records {scene.packed.n_pairs} (SAH "
        f"{bunny.packed.n_pairs}), tri rows {scene.packed.n_rows} (SAH "
        f"{bunny.packed.n_rows}), depth {scene.packed.depth} (SAH "
        f"{bunny.packed.depth})")
    if refs <= n or not set(tree.prim_idx.tolist()) == set(range(n)):
        raise AssertionError("the SBVH duplicated no reference or lost a "
                             "triangle")
    checks = {}
    # #2 and #5 against their plain versions, to the bit
    kernel = bk.render_flat_bvh_megakernel(scene, bunny_cam, **MAIN)
    plain = bk.render_flat_bvh_fused(scene, bunny_cam, **MAIN)
    torch.cuda.synchronize()
    checks["bvh_megakernel"] = [check_images(
        f"#2 over the SBVH bunny {MAIN_SHAPE}", kernel, plain, BVH_TOL,
        exact=True)]
    checks["bvh_megakernel"].append(check_images(
        f"#2 over the SBVH bunny against the SAH tree {MAIN_SHAPE}", kernel,
        bk.render_flat_bvh_megakernel(bunny, bunny_cam, **MAIN), BVH_TOL))
    kernel = sb.render_flat_spectral_bvh_megakernel(scene, bunny_cam,
                                                    **BVH_TIMED)
    plain = sb.render_flat_spectral_bvh_fused(scene, bunny_cam, **BVH_TIMED)
    torch.cuda.synchronize()
    checks["spectral_bvh_megakernel"] = [check_images(
        "#5 over the SBVH bunny 640x360 spp4 d4", kernel, plain, BVH_TOL,
        exact=True)]
    # #3: its plain version to the bit, and the SAH tree's hits
    o, d = rays["primary"]
    got = bk.intersect_tile(scene.packed, o, d, with_slot=True)
    want = bk.intersect_packed_plain(scene.packed, o, d, None, True)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[sbvh] #3 over the SBVH on the bunny's primary rays: t, normal, "
        f"mat id, slot bit-equal to the plain walk: {equal} (required)")
    if not equal:
        raise AssertionError("#3 over the SBVH disagrees with its plain walk")
    checks["bvh_intersect"] = [compare_hits(
        "#3 over the SBVH, primary rays", got, bk.intersect_tile(
            bunny.packed, o, d, with_slot=True))]
    for bounce, (o_, d_, a_, ref) in enumerate(bounce_calls):
        checks["bvh_intersect"].append(compare_hits(
            f"#3 over the SBVH, render_flat's bounce {bounce} (sample 0)",
            bk.intersect_tile(scene.packed, o_, d_, active=a_,
                              with_slot=True), ref))
    # the entry points over the SBVH, counts set to 0 just before each
    w, h = MAIN["width"], MAIN["height"]
    for what, kernel_name, fn in (
            ("render auto: SBVH bunny", "bvh_megakernel",
             lambda: sp.render(scene, bunny_cam, w, h,
                               samples_per_pixel=MAIN["spp"],
                               max_depth=MAIN["max_depth"])),
            ("render auto: spectral SBVH bunny", "spectral_bvh_megakernel",
             lambda: sp.render(scene, bunny_cam, w, h, spectral=True,
                               samples_per_pixel=MAIN["spp"],
                               max_depth=MAIN["max_depth"])),
            ("render_flat: SBVH bunny", "bvh_intersect",
             lambda: sp.render_flat(scene, bunny_cam, **MAIN))):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got_counts = counts()
        main_runs[what] = got_counts
        want = dict.fromkeys(got_counts, 0)
        want[kernel_name] = (MAIN["spp"] * MAIN["max_depth"]
                             if kernel_name == "bvh_intersect" else 1)
        finite = bool(np.isfinite(np.asarray(out.cpu() if torch.is_tensor(
            out) else out, dtype=np.float64)).all())
        log(f"[sbvh] {what} {MAIN_SHAPE}: shape {tuple(out.shape)}, finite "
            f"{finite}, launches {got_counts}")
        if got_counts != want or not finite:
            raise AssertionError(f"{what}: launches {got_counts}, not {want}")
    # the walk's counted work on both trees, then the times on one call
    _, ctr = bk.render_bvh_with_counters(scene, bunny_cam, **MAIN)
    _, ctr_sah = bk.render_bvh_with_counters(bunny, bunny_cam, **MAIN)
    log(f"[sbvh] {card}: #2's counted walk {MAIN_SHAPE} over the SBVH "
        f"{ctr}; over the SAH tree {ctr_sah}")
    times = {}
    for name, fn, shape in (
            ("bvh_megakernel", bk.render_flat_bvh_megakernel, MAIN),
            ("spectral_bvh_megakernel",
             sb.render_flat_spectral_bvh_megakernel, MAIN)):
        times[name] = dict(
            sbvh_ms=time_ms(lambda fn=fn: fn(scene, bunny_cam, **shape)),
            sah_ms=time_ms(lambda fn=fn: fn(bunny, bunny_cam, **shape)))
    times["bvh_intersect"] = dict(
        sbvh_ms=time_ms(lambda: bk.intersect_tile(scene.packed, o, d)),
        sah_ms=time_ms(lambda: bk.intersect_tile(bunny.packed, o, d)),
        sbvh_bounces_ms=sum(time_ms(
            lambda c=c: bk.intersect_tile(scene.packed, c[0], c[1],
                                          active=c[2], with_slot=True))
            for c in bounce_calls),
        sah_bounces_ms=sum(time_ms(
            lambda c=c: bk.intersect_tile(bunny.packed, c[0], c[1],
                                          active=c[2], with_slot=True))
            for c in bounce_calls))
    for name, t in times.items():
        log(f"[sbvh] {card}: {name} over the SBVH bunny "
            + ("primary rays 640x360" if name == "bvh_intersect"
               else MAIN_SHAPE)
            + f": {t['sbvh_ms']:.4f} ms, over the SAH tree on the same call "
            f"{t['sah_ms']:.4f} ms"
            + (f"; render_flat's four calls of a sample "
               f"{t['sbvh_bounces_ms']:.4f} ms against "
               f"{t['sah_bounces_ms']:.4f}" if name == "bvh_intersect"
               else ""))
    if not all(math.isfinite(x) for t in times.values() for x in t.values()):
        raise AssertionError("SBVH timing failed")
    summary = dict(build_s=t_build, pack_s=t_pack, refs_per_triangle=refs / n,
                   nodes=tree.node_count, sah_nodes=bunny.bvh.node_count,
                   counters=ctr, sah_counters=ctr_sah)
    return {k: dict(checks=checks[k], times=times[k], **summary)
            for k in checks}


#: the examples the examples phase runs through their __main__, with the
#: JAX scripts' arguments (the inverse loop at EXAMPLE_STEPS steps), each
#: with the image it writes ((height, width) or None) and the kernel its
#: main path launches (None: the wavefront's plain PyTorch, no kernel)
EXAMPLE_STEPS = 10
EXAMPLES = (
    ("basic_render", ["{out}/basic_render.png"], (360, 640), "megakernel"),
    ("dof_render", ["{out}/dof_render.png"], (360, 640), "megakernel"),
    ("cornell_spectral", ["{out}/cornell.png"], (512, 512),
     "spectral_megakernel"),
    ("mesh_bvh", ["{root}/assets/trefoil.obj", "{out}/mesh_render.png"],
     (360, 640), "bvh_megakernel"),
    ("adaptive_render", ["{out}/adaptive.png", "0.05"], (360, 640), None),
    ("inverse_rendering", [str(EXAMPLE_STEPS)], None, None),
)
#: a kernel example's reduced frame against its plain version: channel
#: means within EXAMPLE_MEAN_REL
EXAMPLE_REDUCED = dict(width=160, height=90, spp=4)
EXAMPLE_MEAN_REL = 0.005


def example_reduced(sp, name):
    """The example's scene at EXAMPLE_REDUCED through its kernel and its
    plain version: (kernel flat, plain flat)."""
    import importlib

    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import megakernel as mk
    from spira_tpu_torch.kernels import spectral_fused as sf

    mod = importlib.import_module(f"spira_tpu_torch.examples.{name}")
    w, h = EXAMPLE_REDUCED["width"], EXAMPLE_REDUCED["height"]
    kw = dict(EXAMPLE_REDUCED, max_depth=4, seed=0)
    if name == "mesh_bvh":
        root = os.path.dirname(os.path.abspath(__file__))
        scene, cam = mod.scene_and_camera(
            w / h, os.path.join(root, "assets", "trefoil.obj"), "cuda")
        pair = bk.render_flat_bvh_megakernel, bk.render_flat_bvh_fused
    else:
        scene, cam = mod.scene_and_camera(w / h, "cuda")
        pair = ((sf.render_flat_spectral_megakernel,
                 sf.render_flat_fused_spectral) if name == "cornell_spectral"
                else (mk.render_flat_megakernel, mk.render_flat_fused))
    if name == "cornell_spectral":
        kw["max_depth"] = 6
    return tuple(fn(scene, cam, **kw) for fn in pair)


def examples_phase(sp, card, out_dir, main_runs):
    """Phase 3e: each example of ``spira_tpu_torch.examples`` through its
    ``__main__`` at the JAX script's sizes (``runpy``, the script's argv),
    the launch counts set to 0 just before and read just after; its image
    read back (finite, of its shape, not constant) or the inverse loop's
    printed losses (finite); a kernel example's reduced frame against its
    plain version; then ``distributed_render`` as 2 ranks on this card
    (gloo).  ``[examples]`` lines with each one's wall seconds.  Returns
    the paths by kernel."""
    import contextlib
    import io
    import runpy

    from spira_tpu_torch.io import image as img_io

    root = os.path.dirname(os.path.abspath(__file__))
    paths = {}
    for name, argv, shape, kernel in EXAMPLES:
        argv = [a.format(out=out_dir, root=root) for a in argv]
        module = f"spira_tpu_torch.examples.{name}"
        saved, buf = sys.argv, io.StringIO()
        sys.argv = [module] + argv
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_module(module, run_name="__main__",
                                 alter_sys=True)
            torch.cuda.synchronize()
        finally:
            sys.argv = saved
        wall = time.perf_counter() - t0
        got = counts()
        main_runs[f"example {name}"] = got
        text = buf.getvalue()
        if shape is not None:
            img = img_io.load_png(argv[-2] if name == "adaptive_render"
                                  else argv[-1])
            ok = img.shape == (*shape, 3) and img.std() > 0
            what = f"image {img.shape}, mean {img.mean():.4f}"
        else:  # the inverse loop: the losses it printed every 10 steps
            losses = [float(line.split()[3]) for line in text.splitlines()
                      if line.startswith("step ")]
            ok = (len(losses) == -(-EXAMPLE_STEPS // 10)
                  and all(math.isfinite(x) for x in losses)
                  and "recovered albedo" in text)
            what = f"losses every 10 steps {losses}"
        reduced = ""
        if kernel is not None:
            ok = ok and got[kernel] >= 1
            k_flat, p_flat = example_reduced(sp, name)
            rel = float(((k_flat.mean(0) / p_flat.mean(0)) - 1).abs().max())
            reduced = (f"; reduced frame {EXAMPLE_REDUCED}: channel means "
                       f"within {rel:.2e} of the plain version's (limit "
                       f"{EXAMPLE_MEAN_REL})")
            ok = ok and rel <= EXAMPLE_MEAN_REL and bool(
                torch.isfinite(k_flat).all())
            paths.setdefault(kernel, {})[f"example {name}"] = got[kernel]
        log(f"[examples] {card}: {name} {' '.join(argv)}: {wall:.2f} s wall"
            f" (in this process); {what}; launches "
            f"{ {k: v for k, v in got.items() if v} }{reduced}; printed "
            f"{text.strip().splitlines()[0] if text.strip() else ''!r}")
        if not ok:
            raise AssertionError(f"example {name} failed its checks:\n{text}")
    # distributed_render: two ranks on this card, gloo (NCCL refuses two
    # ranks on one card), each a process from its __main__
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        logs.append(open(os.path.join(out_dir, f"distributed{rank}.log"),
                         "w+"))
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "spira_tpu_torch.examples.distributed_render", "--backend",
             "gloo"], cwd=out_dir, env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=WORLD_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    wall = time.perf_counter() - t0
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read())
        f.close()
    png = os.path.join(out_dir, "distributed_render.png")
    ok = (all(p.returncode == 0 for p in procs) and os.path.exists(png))
    img = img_io.load_png(png) if ok else None
    ok = ok and img.shape == (320, 640, 3) and img.std() > 0
    log(f"[examples] {card}: distributed_render --backend gloo, 2 ranks on "
        f"one card: {wall:.2f} s wall (2 processes, their imports "
        f"included); exit codes {[p.returncode for p in procs]}; image "
        f"{None if img is None else img.shape}; rank 0 printed "
        f"{text[0].strip().splitlines()[-2:]!r}")
    if not ok:
        raise AssertionError("distributed_render failed:\n" + "\n".join(
            t[-3000:] for t in text))
    return paths


#: the material gathers' backward (kernels/row_gather.py): the kernel
#: against its plain version, each value within this share of the sum of
#: its rays' cotangents' magnitudes (index_add_ on the card adds in any
#: order); against index_put_ (autograd's backward of table[idx]), whose
#: order it keeps, to the bit
ROW_GATHER_SUM_RTOL = 1e-6
#: an H100's latency of one float add on the result of the last
ROW_GATHER_ADD_CYCLES = 4
#: (rays, rows, each table's trailing shape, row 0's share): the bunny
#: step's gathers at 640x360 (albedo and emission of three materials, most
#: rays on the bunny's row 0, which misses carry too), every ray on row 0,
#: a ray count no multiple of the kernel's tile, the spectral step's SPD
#: tables, one ray, and tables at the caps of row_gather.MAX_COLUMNS (53
#: columns) and MAX_SLOTS (1,024 values)
ROW_GATHER_CASES = {
    "bunny_step": (230_400, 3, ((3,), (3,)), 0.9),
    "all_row0": (230_400, 3, ((3,), (3,)), 1.0),
    "ragged": (100_003, 3, ((3,), (3,), (2,)), 0.7),
    "spectral_spd": (230_400, 3, ((24,), (24,)), 0.9),
    "one_ray": (1, 3, ((3,),), 0.0),
    "columns_cap": (50_000, 18, ((53,),), 0.5),
    "values_cap": (50_000, 256, ((4,),), 0.3),
}


def row_gather_inputs(case, device, seed=0):
    """(idx, cotangents, table shapes) of a :data:`ROW_GATHER_CASES` case."""
    n, rows, trailing, share = ROW_GATHER_CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, rows, (n,), generator=g, device=device)
    on0 = torch.rand(n, generator=g, device=device) < share
    idx = torch.where(on0, torch.zeros_like(idx), idx)
    cots = [torch.randn((n, *s), generator=g, device=device)
            for s in trailing]
    return idx, cots, [(rows, *s) for s in trailing]


def row_gather_phase(card, device):
    """The material gathers' backward on the card: for each case of
    :data:`ROW_GATHER_CASES`, the kernel (one launch for all the tables)
    bit-equal over repeated launches and to ``index_put_(accumulate=True)``
    table by table, and against its plain version (``index_add_`` into
    zeros) within :data:`ROW_GATHER_SUM_RTOL`; at the bunny step's shape,
    its time beside the plain version's and ``index_put_``'s (autograd's
    backward of ``table[idx]``, the library's yardstick), its time on the
    card, its byte bound, N (8 + 4 columns), and the bound of its chain of
    adds, N dependent adds at :data:`ROW_GATHER_ADD_CYCLES` each at the
    card's SM clock.  Returns the kernel's entry."""
    from spira_tpu_torch.bench import timing
    from spira_tpu_torch.bench.timing import cuda_ms as time_ms
    from spira_tpu_torch.kernels import row_gather as rg
    from spira_tpu_torch.utils import sol

    def library(idx, cots, shapes):
        return [torch.zeros(s, device=device).index_put_(
            (idx,), c, accumulate=True) for c, s in zip(cots, shapes)]

    checks = []
    for case in ROW_GATHER_CASES:
        idx, cots, shapes = row_gather_inputs(case, device)
        rg.row_gather_backward.launches = 0
        got = [rg.row_gather_backward(idx, cots, shapes) for _ in range(3)]
        plain = rg.row_gather_plain(idx, cots, shapes)
        mag = rg.row_gather_plain(idx, [c.abs() for c in cots], shapes)
        lib = library(idx, cots, shapes)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for g in got[1:]
                   for a, b in zip(got[0], g))
        as_lib = all(torch.equal(a, b) for a, b in zip(got[0], lib))
        err = max(float((a - p).abs().max()) for a, p in zip(got[0], plain))
        rel = max(float(((a - p).abs() / m.clamp(min=1e-30)).max())
                  for a, p, m in zip(got[0], plain, mag))
        launches = rg.row_gather_backward.launches
        log(f"[row_gather] {case}: {idx.shape[0]} rays, tables {shapes}: "
            f"bit-equal over 3 launches {same} and to index_put_ {as_lib} "
            f"(both required); against index_add_ max abs error {err:.3g}, "
            f"worst error over the magnitudes summed {rel:.3g} (limit "
            f"{ROW_GATHER_SUM_RTOL}); launches {launches}")
        if (not same or not as_lib or rel > ROW_GATHER_SUM_RTOL
                or launches != 3):
            raise AssertionError(f"row_gather {case}: bit-equal {same}, to "
                                 f"index_put_ {as_lib}, error {rel}, "
                                 f"launches {launches}")
        checks.append(dict(case=case, bit_equal=same, index_put_bits=as_lib,
                           max_abs_err=err, max_rel_to_magnitude=rel))

    idx, cots, shapes = row_gather_inputs("bunny_step", device)

    ms = time_ms(lambda: rg.row_gather_backward(idx, cots, shapes))
    plain_ms = time_ms(lambda: rg.row_gather_plain(idx, cots, shapes))
    library_ms = time_ms(lambda: library(idx, cots, shapes))
    prof = device_breakdown(lambda: rg.row_gather_backward(idx, cots,
                                                           shapes))
    card_ms = prof["kernels_ms_per_call"].get("spira::row_gather_backward")
    n = idx.shape[0]
    columns = sum(c[0].numel() for c in cots)
    nbytes = n * (8 + 4 * columns)
    bound_ms = nbytes / sol.HBM_BYTES_PER_S * 1e3
    # the order kept: a chain of n dependent float adds (4 cycles each)
    chain_ms = n * ROW_GATHER_ADD_CYCLES / timing.max_sm_clock_hz() * 1e3
    shape = (f"bunny step gathers: {n} rays, albedo and emission (3, 3), "
             f"{ROW_GATHER_CASES['bunny_step'][3]} on row 0")
    log(f"[row_gather] {card}: {shape}: {ms:.4f} ms (wrapper, CUDA events), "
        f"on the card {card_ms} ms; plain (index_add_) {plain_ms:.4f} ms; "
        f"index_put_(accumulate=True) {library_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by bytes ({nbytes} B); the kept order's chain "
        f"of {n} dependent adds {chain_ms:.4f} ms")
    log_breakdown(card, "row_gather_backward bunny step", prof)
    return {
        "name": "row_gather_backward",
        "route": "cuda",
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_term": "bytes",
        "bound_terms_ms": dict(alu=0.0, special=0.0, bytes=bound_ms),
        "datasheet_bound_ms": bound_ms,
        "chain_ms": chain_ms,
        "library_ms": library_ms,
        "source": "spira_tpu_torch/csrc/row_gather.cu",
        "replaces": "no Pallas kernel: JAX gathers material rows by one-hot "
                    "products (spira_tpu/integrator/bsdf.py:30-47)",
        "launches": 3 * len(checks),
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": ms,
        "card_ms": card_ms,
        "plain_ms": plain_ms,
        "shape": shape,
        "host_ms": None if card_ms is None else ms - card_ms,
        "profile": prof,
        "checks": checks,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save", help="also write the main paths' PNGs "
                        "into this directory")
    parser.add_argument("--parent", help="a checkout of another commit "
                        "(unpacked into an ignored directory): also time "
                        "its adjoint kernel and step with "
                        "spira_tpu_torch/bench/grad_step.py and its "
                        "frames with spira_tpu_torch/bench/mesh_frame.py, "
                        "each in a process of its own")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1

    # ---- 1. card and toolchain
    import spira_tpu_torch as sp
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import grad_step as gs
    from spira_tpu_torch.bench import intersect_bounces as ib
    from spira_tpu_torch.bench.mesh_frame import primary_rays
    from spira_tpu_torch.bench import packet_profile as pp
    from spira_tpu_torch.bench import superleaf as superleaf_bench
    from spira_tpu_torch.bench import timing
    from spira_tpu_torch.bench.timing import card_line
    from spira_tpu_torch.bench.timing import cuda_ms as time_ms
    from spira_tpu_torch.bench import vpu_peak as vp
    from spira_tpu_torch.io import image as img_io
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import grad_megakernel as gk
    from spira_tpu_torch.kernels import megakernel as mk
    from spira_tpu_torch.kernels import mxu_megakernel as xk
    from spira_tpu_torch.kernels import row_gather as rg
    from spira_tpu_torch.kernels import spectral_bvh as sb
    from spira_tpu_torch.kernels import spectral_fused as sf
    from spira_tpu_torch.render import mesh_replay_launches
    from spira_tpu_torch.utils import sol

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    names = ("megakernel", "bvh_megakernel", "spectral_megakernel",
             "grad_megakernel", "mxu_megakernel", "peak", "row_gather")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.load, names)))
    ptxas = {}
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.build_seconds:.1f} s "
            f"({'built' if lib.build_seconds else 'cached'}) -> "
            f"{lib.path.name}")
        # ptxas -v: "Compiling entry function '<mangled>'", then the
        # stack/spill and register lines of that kernel
        kernel = None
        for line in lib.log.splitlines():
            found = re.search(r"entry function '_ZN5spira(\d+)(\w+)", line)
            if found:
                kernel = found.group(2)[:int(found.group(1))]
            elif kernel and ("spill" in line or "registers" in line):
                ptxas.setdefault(kernel, []).append(line.strip())
    for kernel, lines in ptxas.items():
        log(f"[ptxas] {kernel}: {' | '.join(lines)}")

    # ---- 1b. the peak-rate probes (#9, #10): each against its plain
    # version at the JAX shape, then the profilers' runs at a grid that
    # fills every SM, each output held against the plain version; #9's
    # rates give the special-function weights of every bound below
    launches = {}
    # the kernels' launches in one frame or step of each main path
    main_runs = {}
    probe_checks = check_probes_jax_shapes(vp, pp, device)
    probe = dict(n_peak=vp.fill_elements(device),
                 n_dtype=vp.fill_elements(device, pp.WAVES))
    x_peak = vp.probe_input(probe["n_peak"], device)
    reset_counts()
    peak_ms, peak_out = vp.time_modes(x_peak)
    dtype_rows, dtype_out = pp.tier_vpu(device, card=card)
    torch.cuda.synchronize()
    got = counts()
    for kernel in ("vpu_peak", "vpu_dtype"):
        launches[kernel] = got[kernel]
        if got[kernel] < 11:
            raise AssertionError(f"the probes launched {kernel} "
                                 f"{got[kernel]} times")
    if sum(got.values()) != got["vpu_peak"] + got["vpu_dtype"]:
        raise AssertionError(f"the probes launched {got}")
    # the timed launches' outputs, against the plain versions on the same
    # inputs (tier_vpu steps vpu_peak.probe_input of each grid's size)
    probe_checks += check_peak(vp, x_peak, peak_out,
                               f"fill grid {probe['n_peak']} varied")
    for grid, n in (("jax", pp.ROWS * pp.COLS), ("fill", probe["n_dtype"])):
        probe_checks += check_dtype(
            pp, vp.probe_input(n, device),
            {d: dtype_out[grid, d] for d in pp.DTYPES},
            f"{grid} grid {n} varied")
    peak_checks = [c for c in probe_checks if c["case"].startswith("#9")]
    dtype_checks = [c for c in probe_checks if c["case"].startswith("#10")]
    peak_rates = vp.rates_from_ms(peak_ms, probe["n_peak"])
    issue_rate = sol.issue_rate_per_s(
        torch.cuda.get_device_properties(0).multi_processor_count,
        timing.max_sm_clock_hz())
    rates = vp.sol_rates(peak_rates, issue_rate, f"{card}, this run")
    dtype_ms = {(r["grid"], r["dtype"]): r["ms"] for r in dtype_rows}
    for mode in vp.MODES:
        log(f"[probe] {card}: #9 {mode}, {probe['n_peak']} elements: "
            f"{peak_ms[mode]:.4f} ms, {peak_rates[mode]:.5g} "
            f"{'lane-ops' if mode in vp.INSTRUCTIONS else 'calls'}/s")
    for r in dtype_rows:
        log(f"[probe] {card}: #10 {r['dtype']} {r['grid']} grid, "
            f"{r['elements']} elements: {r['ms']:.4f} ms, "
            f"{r['gflop_s']:.6g} GFLOP/s")
    achieved = peak_rates["separate"]  # 3 lane-ops, 3 instructions a step
    contracted = (peak_rates["contracted"] * vp.INSTRUCTIONS["contracted"]
                  / vp.LANE_OPS)
    log(f"[probe] {card}: issue rate {issue_rate:.5g} instructions/s "
        f"({sol.LANES_PER_SM_CLOCK} lanes a clock an SM at the max SM "
        f"clock); #9 separate issues {achieved:.5g} ALU instructions/s "
        f"({achieved / issue_rate:.4f} of it, -fmad=false), contracted "
        f"{contracted:.5g} ({contracted / issue_rate:.4f}); special-function "
        f"weights in ALU instructions "
        f"{({k: round(v, 3) for k, v in rates.weights.items()})}; launches "
        f"{got}")

    t0 = time.perf_counter()
    bunny, info = sp.create_bunny_scene(allow_download=False, device=device)
    mesh = sp.attach_packed(sp.create_mesh_scene(device=device))
    t_pack = time.perf_counter()
    # the superleaf packings, attached once outside the render calls
    bunny_sl = sp.attach_superleaf(bunny)
    bunny_mxu_scene = sp.attach_mxu(bunny)
    bunny_mxu = bunny_mxu_scene.wide
    mesh_sl, mesh_mxu = sp.attach_superleaf(mesh), sp.attach_mxu(mesh)
    log(f"[scene] superleaf packings in {time.perf_counter() - t_pack:.1f} "
        f"s: bunny {bunny_sl.wide.n_blocks} blocks "
        f"({coeff_bytes(bunny_mxu)} bytes), {bunny_sl.wide.n_pairs} pair records, depth "
        f"{bunny_sl.wide.depth}; mesh {mesh_sl.wide.n_blocks} blocks, "
        f"{mesh_sl.wide.n_pairs} pair records, depth {mesh_sl.wide.depth}")
    log(f"[scene] bunny {info}, pair records {bunny.packed.n_pairs}, tri "
        f"rows {bunny.packed.n_rows}, depth {bunny.packed.depth}, max leaf "
        f"{bunny.packed.max_leaf}, tables "
        f"{4 * (bunny.packed.pairs.numel() + bunny.packed.tri_rows.numel())}"
        f" bytes; mesh {mesh.triangles.count} triangles, depth "
        f"{mesh.packed.depth}, max leaf {mesh.packed.max_leaf}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    w, h = MAIN["width"], MAIN["height"]
    bunny_cam = sp.bunny_camera(w / h, device=device)
    mesh_cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                              aspect_ratio=1.0, device=device)
    mesh_wide_cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                   aspect_ratio=w / h, device=device)
    scenes = dict(
        bunny=(bunny, bunny_cam), mesh=(mesh, mesh_cam),
        bunny_sl=(bunny_sl, bunny_cam), mesh_sl=(mesh_sl, mesh_cam),
        mesh_mxu=(mesh_mxu, mesh_cam), mesh_mxu_wide=(mesh_mxu, mesh_wide_cam),
        bunny_mxu=(bunny_mxu_scene, bunny_cam),
        ties_sl=(superleaf_bench.tie_scene(device), mesh_cam),
        demo=(sp.create_scene(device=device),
              sp.default_camera(w / h, device=device)),
        cornell=(sp.create_cornell_box(device=device),
                 sp.cornell_camera(w / h, device=device)),
        cornell_sq=(sp.create_cornell_box(device=device),
                    sp.cornell_camera(1.0, device=device)),
        dispersive=(dispersive_mesh(sp, device),
                    sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                   aspect_ratio=1.0, device=device)),
        lens=(sp.create_scene(device=device),
              sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                             aspect_ratio=2.0, aperture=0.2, focus_dist=3.0,
                             device=device)),
        inside=(sp.create_scene(device=device),
                sp.make_camera((0.0, 5.0, 0.0), (0.0, 5.0, -1.0),
                               aspect_ratio=2.0, device=device)),
    )

    # ---- 2. each kernel against its plain version on the card
    sphere_checks = [compare_sphere(sp, mk, *case, device)
                     for case in SPHERE_CASES]
    rays = dict(random=random_rays(N_RANDOM_RAYS, device),
                primary=primary_rays(bunny_cam, w, h))
    isect_checks = [
        compare_intersect(
            f"bunny {key} rays",
            lambda o, d: bk.intersect_tile(bunny.packed, o, d),
            lambda o, d: bk.intersect_packed_plain(bunny.packed, o, d),
            *rays[key])
        for key in ("random", "primary")]
    mxu_isect_checks = [
        compare_intersect(
            f"#8 bunny {key} rays",
            lambda o, d: xk.intersect_tile_mxu(bunny_mxu, o, d),
            lambda o, d: xk.intersect_mxu_plain(bunny_mxu, o, d),
            *rays[key], exact=True)
        for key in ("random", "primary")]
    mxu_renders = dict(mxu=(xk.render_flat_mxu_megakernel,
                            xk.render_flat_mxu_fused),
                       mxu_global=(lambda scene, cam, **k: xk._launch_render(
                           scene, cam, scene.wide, "global", seed=0,
                           inclusive_uv=True, **k), xk.render_flat_mxu_fused),
                       bvh_mxu=(bk.render_flat_bvh_mxu_megakernel,
                                lambda *a, **k: bk.render_flat_bvh_fused(
                                    *a, mxu_leaf=True, **k)))
    # (engine, check): each image equal to its plain version's to the bit;
    # #7's checks name the route it ran
    mxu_checks = []
    for name, engine, key, shape in MXU_CASES:
        scene, cam = scenes[key]
        kernel_fn, plain_fn = mxu_renders[engine]
        reset_counts()
        kernel = kernel_fn(scene, cam, **shape)
        ran = dict(xk.render_flat_mxu_megakernel.routes)
        plain = plain_fn(scene, cam, **shape)
        torch.cuda.synchronize()
        check = check_images(name, kernel, plain, BVH_TOL, exact=True)
        if engine != "bvh_mxu":
            check["route"] = next(r for r, k in ran.items() if k)
        mxu_checks.append((engine, check))
    routes_by_size = {c["case"]: c["route"] for e, c in mxu_checks
                      if e == "mxu"}
    log(f"[compare] #7's routes: {routes_by_size}")
    if set(routes_by_size.values()) != set(xk.ROUTES):
        raise AssertionError(f"#7 did not take both routes by size: "
                             f"{routes_by_size}")
    bvh_checks = []
    for name, key, shape in BVH_CASES:
        scene, cam = scenes[key]
        kernel = bk.render_flat_bvh_megakernel(scene, cam, **shape)
        plain = bk.render_flat_bvh_fused(scene, cam, **shape)
        torch.cuda.synchronize()
        bvh_checks.append(check_images(name, kernel, plain, BVH_TOL,
                                       exact=True))
    bounce_checks, bounce_calls = check_wavefront_rays(bk, ib, bunny,
                                                       bunny_cam)
    wavefront_checks = [check_wavefront_hook(sp, bk, bunny, bunny_cam),
                        *bounce_checks]
    mesh_grad_checks = [check_mesh_backward(sp, bk, gs, bunny, bunny_cam,
                                            spectral)
                        for spectral in (False, True)]
    counted_checks = check_counted(bk, bunny, bunny_cam)
    counted = counted_checks["counters_640x360_spp4_d4"]
    spectral_checks = []
    for name, key, shape, tol in SPECTRAL_CASES:
        scene, cam = scenes[key]
        kernel = sf.render_flat_spectral_megakernel(scene, cam, seed=7,
                                                    **shape)
        plain = sf.render_flat_fused_spectral(scene, cam, seed=7, **shape)
        torch.cuda.synchronize()
        spectral_checks.append(check_images(name, kernel, plain, tol,
                                            exact=True))
    spectral_bvh_checks = []
    for name, key, shape in SPECTRAL_BVH_CASES:
        scene, cam = scenes[key]
        kernel = sb.render_flat_spectral_bvh_megakernel(scene, cam, **shape)
        plain = sb.render_flat_spectral_bvh_fused(scene, cam, **shape)
        torch.cuda.synchronize()
        spectral_bvh_checks.append(check_images(name, kernel, plain,
                                                BVH_TOL, exact=True))
    grad_checks = []
    for name, key, shape, grad_spp, loss_mode in GRAD_CASES:
        scene, cam = scenes[key]
        if key == "demo":  # the demo camera at the case's aspect
            cam = sp.default_camera(shape["width"] / shape["height"],
                                    device=device)
        grad_checks.append(compare_grad(gk, mk, name, scene, cam, shape,
                                        grad_spp, loss_mode))
    loss_forward_check = check_loss_forward(gk, mk, *scenes["demo"])
    m_shape = GRAD_CASES[0][2]
    fd_checks = check_finite_differences(
        sp, scenes["demo"][0],
        sp.default_camera(m_shape["width"] / m_shape["height"],
                          device=device), m_shape)

    # ---- 3. the main paths, through the user's entry points
    main_args = dict(samples_per_pixel=MAIN["spp"],
                     max_depth=MAIN["max_depth"])
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.save or tmp
        os.makedirs(out_dir, exist_ok=True)
        # the bunny, engine "auto" -> cuda_bvh
        def to_uint8(flat):
            return img_io.to_uint8(img_io.TONEMAPS["gamma"](
                img_io.assemble_image(flat, w, h)))

        shape_name = f"{w}x{h} spp{MAIN['spp']} d{MAIN['max_depth']}"
        png = os.path.join(out_dir, "chip_smoke_bunny.png")
        reset_counts()
        img = sp.render(bunny, bunny_cam, w, h, output_path=png, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_megakernel"] = got["bvh_megakernel"]
        main_runs["render auto: bunny"] = got
        check_main(f"bunny render {shape_name}", "bvh_megakernel", img,
                   to_uint8(bk.render_flat_bvh_fused(bunny, bunny_cam,
                                                     **MAIN)), got, png)

        # the counting build of #2 on the bunny: one launch, nothing else
        reset_counts()
        _, ctr = bk.render_bvh_with_counters(bunny, bunny_cam, **MAIN)
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_counted"] = got["bvh_counted"]
        want = dict.fromkeys(got, 0)
        want["bvh_counted"] = 1
        log(f"[main] bunny render_bvh_with_counters {shape_name}: "
            f"{ctr}, launches {got}")
        if got != want:
            raise AssertionError(f"render_bvh_with_counters launched {got}")

        # the nearest-hit query on the bunny's primary rays
        reset_counts()
        t, n, mid = bk.intersect_tile(bunny.packed, *rays["primary"])
        torch.cuda.synchronize()
        got = counts()
        launches["bvh_intersect"] = got["bvh_intersect"]
        hits = t < 1e19
        log(f"[main] bunny primary rays {w}x{h}: {int(hits.sum())} hits, "
            f"{int((mid == 0).sum())} on the mesh, launches {got}")
        if got["bvh_intersect"] < 1:
            raise AssertionError("intersect path did not launch its kernel")
        if not (0 < int((mid == 0).sum()) < t.numel()):
            raise AssertionError("primary rays miss the bunny or hit all")

        # the sphere demo scene, engine "auto" -> cuda
        demo, demo_cam = scenes["demo"]
        png = os.path.join(out_dir, "chip_smoke_demo.png")
        reset_counts()
        img = sp.render(demo, demo_cam, w, h, output_path=png, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["megakernel"] = got["megakernel"]
        main_runs["render auto: demo"] = got
        check_main(f"demo render {shape_name}", "megakernel", img,
                   sp.render(demo, demo_cam, w, h, engine="fused",
                             **main_args), got, png)

        # the spectral paths: the spectral kernel launched, no RGB kernel
        rgb_kernels = ("megakernel", "bvh_megakernel", "bvh_intersect")
        # the spectral Cornell box, engine "auto" -> cuda, spectral
        cornell, cornell_cam = scenes["cornell"]
        png = os.path.join(out_dir, "chip_smoke_cornell_spectral.png")
        reset_counts()
        img = sp.render(cornell, cornell_cam, w, h, output_path=png,
                        spectral=True, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["spectral_megakernel"] = got["spectral_megakernel"]
        main_runs["render auto: spectral cornell"] = got
        check_main(f"spectral cornell render {shape_name}",
                   "spectral_megakernel", img,
                   sp.render(cornell, cornell_cam, w, h, engine="fused",
                             spectral=True, **main_args), got, png)
        if any(got[k] for k in rgb_kernels):
            raise AssertionError("spectral cornell path launched an RGB "
                                 "kernel")
        rgb_img = sp.render(cornell, cornell_cam, w, h, **main_args)
        rgb_gap = float(abs(img.astype(float) - rgb_img).mean())
        log(f"[main] spectral cornell against RGB cornell at the same "
            f"shape and seed: mean abs gap {rgb_gap:.4f} levels")
        if rgb_gap == 0.0:
            raise AssertionError("spectral cornell equals the RGB image")

        # the spectral bunny, engine "auto" -> cuda_spectral_bvh
        png = os.path.join(out_dir, "chip_smoke_bunny_spectral.png")
        reset_counts()
        img = sp.render(bunny, bunny_cam, w, h, output_path=png,
                        spectral=True, **main_args)
        torch.cuda.synchronize()
        got = counts()
        launches["spectral_bvh_megakernel"] = got["spectral_bvh_megakernel"]
        main_runs["render auto: spectral bunny"] = got
        check_main(f"spectral bunny render {shape_name}",
                   "spectral_bvh_megakernel", img,
                   to_uint8(sb.render_flat_spectral_bvh_fused(
                       bunny, bunny_cam, **MAIN)), got, png)
        if any(got[k] for k in rgb_kernels):
            raise AssertionError("spectral bunny path launched an RGB "
                                 "kernel")

        # the wavefront estimator: render_flat on the bunny, every bounce's
        # nearest hits from #3, spp x depth launches and nothing else
        png = os.path.join(out_dir, "chip_smoke_bunny_wavefront.png")
        reset_counts()
        wave = sp.render_flat(bunny, bunny_cam, **MAIN)
        torch.cuda.synchronize()
        got = counts()
        main_runs["render_flat: bunny"] = got
        want = dict.fromkeys(got, 0)
        want["bvh_intersect"] = MAIN["spp"] * MAIN["max_depth"]
        img = to_uint8(wave)
        img_io.save_png(png, img)
        log(f"[main] bunny render_flat {shape_name}: image {img.shape}, "
            f"mean {img.mean():.4f}, std {img.std():.4f}, launches {got}")
        if got != want:
            raise AssertionError(f"render_flat launched {got}, not {want}")
        launches["bvh_intersect"] = got["bvh_intersect"]
        # the wavefront engine against the kernel engines of the same
        # scenes, RGB and spectral, within the noise floor
        for spectral, kernel_fn in ((False, bk.render_flat_bvh_megakernel),
                                    (True,
                                     sb.render_flat_spectral_bvh_megakernel)):
            waves = [sp.render_flat_engine(bunny, bunny_cam,
                                           engine="wavefront", seed=seed,
                                           spectral=spectral, **MAIN)
                     for seed in (0, 1)]
            if not spectral:
                torch.testing.assert_close(waves[0], wave, rtol=0, atol=0)
            wavefront_checks.append(check_noise_floor(
                f"bunny {'spectral ' * spectral}wavefront against "
                f"{'cuda_spectral_bvh' if spectral else 'cuda_bvh'} "
                f"{shape_name}", *waves,
                kernel_fn(bunny, bunny_cam, **MAIN)))
        # render_with_cpu on the sphere demo: the wavefront in reference
        # semantics on the card, no kernel and no plain tracer
        reset_counts()
        img = sp.render_with_cpu(demo, demo_cam, w, h, **main_args)
        got = counts()
        log(f"[main] demo render_with_cpu {shape_name}: image {img.shape}, "
            f"mean {img.mean():.4f}, std {img.std():.4f}, launches {got}")
        if any(got.values()) or img.shape != (h, w, 3) or img.std() == 0:
            raise AssertionError(f"render_with_cpu: launches {got}, image "
                                 f"{img.shape}")
        wavefront_checks.append(check_wavefront_device(
            sp, demo, sp.default_camera(2.0, device=device),
            "demo render_flat reference semantics 48x24 spp2 d4",
            width=48, height=24, spp=2, max_depth=4, seed=5,
            semantics="reference"))
        # engine bvh_sorted: render_flat with the hook's forward form, to
        # the bit, one #3 launch a bounce and nothing else
        reset_counts()
        img = sp.render(bunny, bunny_cam, w, h, engine="bvh_sorted",
                        **main_args)
        got = counts()
        want = dict.fromkeys(got, 0)
        want["bvh_intersect"] = MAIN["spp"] * MAIN["max_depth"]
        same = bool(np.array_equal(img, to_uint8(sp.render_flat(
            bunny, bunny_cam, grad_hook=False, **MAIN))))
        log(f"[main] bunny render engine bvh_sorted {shape_name}: image "
            f"{img.shape}, mean {img.mean():.4f}, equal to render_flat's with"
            f" grad_hook=False to the bit: {same}, launches {got}")
        if got != want or not same:
            raise AssertionError(f"bvh_sorted: launches {got}, equal {same}")

        # the mesh step of bench.py (render_flat_hybrid_grad_mesh,
        # img.mean(), grad_spp 2): one #2 (#5) launch, its image render()'s
        # to the bit, then #3 in the backward's replay and nothing else
        mesh_runs = {}
        for spectral in (False, True):
            fwd = "spectral_bvh_megakernel" if spectral else "bvh_megakernel"
            field = MESH_FIELDS[spectral][0]
            reset_counts()
            rg.row_gather_backward.launches = 0
            loss, flat, grads = gs.mesh_step(sp, bunny, bunny_cam,
                                             spectral=spectral, shape=MAIN)
            torch.cuda.synchronize()
            got = counts()
            # the gathers' backward (not in counts(), whose every other
            # path launches none): one launch a bounce of each replayed
            # sample whose gathered albedo reaches the image, so all but
            # the last, whose albedo scales a throughput no bounce reads
            # (a step that differentiates emission launches one a bounce)
            got["row_gather_backward"] = rg.row_gather_backward.launches
            what = f"render_flat_hybrid_grad_mesh{' spectral' * spectral}"
            main_runs[what] = got
            want = dict.fromkeys(got, 0)
            want[fwd] = 1
            want["bvh_intersect"] = mesh_replay_launches(
                gs.MESH_GRAD_SPP, MAIN["max_depth"])
            want["row_gather_backward"] = gs.MESH_GRAD_SPP * (
                MAIN["max_depth"] - 1)
            same = torch.equal(flat, sp.render_flat_engine(
                bunny, bunny_cam, spectral=spectral, **MAIN))
            g = grads[field]
            log(f"[main] bunny {what} {shape_name} grad_spp "
                f"{gs.MESH_GRAD_SPP}:"
                f" loss {float(loss):.6g}, image equal to render_flat_engine"
                f"'s (engine auto) to the bit: {same}; d loss / d "
                f"{field[1]} of material 0 {g[0].tolist()[:4]}, |max| "
                f"{float(g.abs().max()):.4g}; launches {got} (#3: "
                f"{got['bvh_intersect']})")
            if got != want or not same:
                raise AssertionError(f"{what}: launches {got}, not {want}; "
                                     f"image equal {same}")
            if not torch.isfinite(g).all() or not g[0].abs().max() > 0:
                raise AssertionError(f"{what}: no finite gradient on the "
                                     "bunny's material")
            mesh_runs[what] = dict(loss=float(loss), launches=got,
                                   grad_material0=g[0].tolist())

        # the superleaf engines: one launch of their kernel, nothing else;
        # each image against its plain version at its own spp and against
        # cuda_bvh's image of the same scene and seed (same PCG stream,
        # another intersector)
        main_mxu_checks = []
        for what, kernel, engine, scene, cam, plain_fn, row_scene in (
                ("bunny", "bvh_mxu_megakernel", "cuda_bvh_mxu", bunny_sl,
                 bunny_cam, mxu_renders["bvh_mxu"][1], bunny),
                ("mesh", "mxu_megakernel", "cuda_mxu", mesh_mxu,
                 mesh_wide_cam, mxu_renders["mxu"][1], mesh)):
            png = os.path.join(out_dir, f"chip_smoke_{what}_{engine}.png")
            reset_counts()
            img = sp.render(scene, cam, w, h, output_path=png, engine=engine,
                            **main_args)
            torch.cuda.synchronize()
            got = counts()
            launches[kernel] = got[kernel]
            want = dict.fromkeys(got, 0)
            want[kernel] = 1
            if got != want:
                raise AssertionError(f"{what} render on {engine} launched "
                                     f"{got}, not {want}")
            if engine == "cuda_mxu":
                main_routes = dict(xk.render_flat_mxu_megakernel.routes)
                log(f"[main] #7 on {what}: routes {main_routes}")
                if main_routes != {"staged": 1, "global": 0}:
                    raise AssertionError(f"#7 on {what} took {main_routes}, "
                                         "not the staged route")
            plain = plain_fn(scene, cam, **MAIN)
            check_main(f"{what} render on {engine} {shape_name}", kernel,
                       img, to_uint8(plain), got, png)
            flat = sp.render_flat_engine(scene, cam, engine=engine, **MAIN)
            main_mxu_checks.append(check_images(
                f"{what} {engine} against its plain version {shape_name}",
                flat, plain, BVH_TOL, exact=True))
            main_mxu_checks.append(check_images(
                f"{what} {engine} against cuda_bvh {shape_name}", flat,
                bk.render_flat_bvh_megakernel(row_scene, cam, **MAIN),
                BVH_TOL))

        # the streaming query on the bunny's primary rays, against the
        # packed-BVH query on the same rays
        reset_counts()
        t, n, mid = xk.intersect_tile_mxu(bunny_mxu, *rays["primary"])
        torch.cuda.synchronize()
        got = counts()
        launches["mxu_intersect"] = got["mxu_intersect"]
        want = dict.fromkeys(got, 0)
        want["mxu_intersect"] = 1
        log(f"[main] #8 bunny primary rays {w}x{h}: {int((t < 1e19).sum())}"
            f" hits, {int((mid == 0).sum())} on the mesh, launches {got}")
        if got != want:
            raise AssertionError(f"intersect_tile_mxu launched {got}")
        if not (0 < int((mid == 0).sum()) < t.numel()):
            raise AssertionError("primary rays miss the bunny or hit all")
        main_mxu_checks.append(compare_intersect(
            "#8 bunny primary rays against the packed-BVH query",
            lambda o, d: (t, n, mid),
            lambda o, d: bk.intersect_tile(bunny.packed, o, d),
            *rays["primary"]))

    # the differentiable step of bench.py: forward, MSE against a target
    # rendered at seed 7, backward; gradients for every material field
    step_target = mk.render_flat_megakernel(demo, demo_cam, seed=7, **MAIN)

    def step(albedo, seed, grad_spp):
        return gs.step(sp, demo, demo_cam, step_target, albedo, seed,
                       grad_spp, MAIN)

    albedo0 = demo.materials.albedo.clone()
    albedo0[:2] = torch.tensor(STEP_ALBEDO, device=device)
    launches["grad_megakernel"] = 0
    step_runs = {}
    for grad_spp in (MAIN["spp"], 4):
        albedo, losses = albedo0, []
        for seed in STEP_SEEDS:
            reset_counts()
            loss, grads = step(albedo, seed, grad_spp)
            torch.cuda.synchronize()
            got = counts()
            want = dict.fromkeys(got, 0)
            want.update(megakernel=1, grad_megakernel=1)
            if got != want:
                raise AssertionError(f"step (grad_spp {grad_spp}, seed "
                                     f"{seed}) launched {got}, not {want}")
            for f, g in grads.items():
                if not torch.isfinite(g).all():
                    raise AssertionError(f"step: {f} gradient not finite")
            for f in ("albedo", "emission"):
                if not (grads[f][:2].abs().amax(dim=1) > 0).all():
                    raise AssertionError(f"step: no {f} gradient on the "
                                         f"visible materials 0 and 1")
            launches["grad_megakernel"] += got["grad_megakernel"]
            main_runs[f"step, grad_spp {grad_spp}"] = got
            losses.append(float(loss))
            albedo = (albedo - STEP_LR * grads["albedo"]).clamp(0.0, 1.0)
        step_runs[grad_spp] = dict(
            losses=losses, albedo_0_1=albedo[:2].tolist(),
            last_grad_albedo_0_1=grads["albedo"][:2].tolist())
        log(f"[main] step {w}x{h} spp{MAIN['spp']} d{MAIN['max_depth']} "
            f"grad_spp {grad_spp}: each of {len(losses)} steps one "
            f"megakernel and one grad_megakernel launch, no plain tracer "
            f"call; losses under gradient descent on the albedo (lr "
            f"{STEP_LR}): {[round(x, 6) for x in losses]}; albedo of "
            f"materials 0, 1 now {np.round(albedo[:2].tolist(), 4).tolist()}"
            f" (true {np.round(demo.materials.albedo[:2].tolist(), 4)})")
        if not losses[-1] < losses[0]:
            raise AssertionError("gradient descent did not lower the loss")

    # the loss entry point: loss mode's forward kernel, then the VJP kernel
    reset_counts()
    loss, d_scene, d_cam = sp.render_mse_loss_and_grads(
        demo, demo_cam, step_target, seed=3, **MAIN)
    torch.cuda.synchronize()
    got = counts()
    launches["grad_loss_forward"] = got["grad_loss_forward"]
    main_runs["render_mse_loss_and_grads"] = got
    want = dict.fromkeys(got, 0)
    want.update(grad_megakernel=1, grad_loss_forward=1)
    log(f"[main] render_mse_loss_and_grads {w}x{h} spp{MAIN['spp']} "
        f"d{MAIN['max_depth']}: loss {float(loss):.6g}, launches {got}")
    if got != want:
        raise AssertionError(f"render_mse_loss_and_grads launched {got}")
    if not (torch.isfinite(loss)
            and torch.isfinite(d_scene.materials.albedo).all()
            and torch.isfinite(d_cam.origin).all()
            and float(d_scene.materials.albedo.abs().max()) > 0):
        raise AssertionError("render_mse_loss_and_grads: bad loss or "
                             "gradients")

    # ---- 3b. the command line (cli.main) at the demo preset
    t_cli = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_paths = cli_phase(sp, bk, args.save or tmp, tmp, main_runs)
    log(f"[cli] phase 3b: {time.perf_counter() - t_cli:.1f} s")

    # ---- 3c. sharding on the card: #2 at offsets, the 4x1 split, a
    # 2-rank gloo world and a 1-rank NCCL world
    t_shard = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sharded_paths, offset_checks = sharded_phase(sp, bk, scenes,
                                                     main_runs, tmp)
    log(f"[sharded] phase 3c: {time.perf_counter() - t_shard:.1f} s")

    # ---- 3d. the bunny over an SBVH: #2, #3 and #5 over spatial splits
    t_sbvh = time.perf_counter()
    sbvh = sbvh_phase(sp, bk, sb, card, bunny, bunny_cam, rays, bounce_calls,
                      main_runs)
    log(f"[sbvh] phase 3d: {time.perf_counter() - t_sbvh:.1f} s")

    # ---- 3e. the examples through their __main__
    t_examples = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        examples_paths = examples_phase(sp, card, args.save or tmp,
                                        main_runs)
    log(f"[examples] phase 3e: {time.perf_counter() - t_examples:.1f} s")

    # ---- 3f. the material gathers' backward (kernels/row_gather.py)
    t_rows = time.perf_counter()
    row_gather_entry = row_gather_phase(card, device)
    log(f"[row_gather] phase 3f: {time.perf_counter() - t_rows:.1f} s")

    # ---- 4. timing
    def mrays(shape, ms):
        rays_ = shape["width"] * shape["height"] * shape["spp"] \
            * shape["max_depth"]
        return rays_ / (ms * 1e-3) / 1e6

    def run(fn, scene, cam, shape):
        return lambda: fn(scene, cam, **shape)

    bvh_k = time_ms(run(bk.render_flat_bvh_megakernel, bunny, bunny_cam,
                        BVH_TIMED))
    bvh_p = time_ms(run(bk.render_flat_bvh_fused, bunny, bunny_cam,
                        BVH_TIMED), PLAIN_REPEATS)
    bvh_full = time_ms(run(bk.render_flat_bvh_megakernel, bunny, bunny_cam,
                           MAIN))
    log(f"[time] {card}: bunny 640x360 spp4 d4 kernel {bvh_k:.3f} ms "
        f"({mrays(BVH_TIMED, bvh_k):.1f} Mrays/s), plain {bvh_p:.3f} ms "
        f"({mrays(BVH_TIMED, bvh_p):.2f} Mrays/s), kernel/plain "
        f"{bvh_k / bvh_p:.5f}")
    log(f"[time] {card}: bunny 640x360 spp16 d4 kernel {bvh_full:.3f} ms "
        f"({mrays(MAIN, bvh_full):.1f} Mrays/s)")
    counted_k = time_ms(lambda: bk.render_bvh_with_counters(
        bunny, bunny_cam, **BVH_TIMED))
    counted_full = time_ms(lambda: bk.render_bvh_with_counters(
        bunny, bunny_cam, **MAIN))
    log(f"[time] {card}: bunny counting build spp4 d4 {counted_k:.3f} ms, "
        f"spp16 d4 {counted_full:.3f} ms: {counted_k / bvh_k:.4f} and "
        f"{counted_full / bvh_full:.4f} of the uncounted kernel's")
    peak_plain_ms = time_ms(lambda: vp.peak_plain(x_peak), PLAIN_REPEATS)
    x_dtype = vp.probe_input(probe["n_dtype"], device)
    dtype_plain_ms = time_ms(lambda: pp.vpu_dtype_plain(x_dtype),
                             PLAIN_REPEATS)
    log(f"[time] {card}: probes' plain versions at the fill grid: #9 "
        f"separate {peak_plain_ms:.3f} ms, #10 f32 {dtype_plain_ms:.3f} ms")
    isect_k = time_ms(lambda: bk.intersect_tile(bunny.packed,
                                                *rays["primary"]))
    isect_p = time_ms(lambda: bk.intersect_packed_plain(
        bunny.packed, *rays["primary"]), PLAIN_REPEATS)
    log(f"[time] {card}: bunny primary rays 640x360 intersect kernel "
        f"{isect_k:.4f} ms ({w * h / (isect_k * 1e-3) / 1e6:.1f} Mrays/s), "
        f"plain {isect_p:.3f} ms, kernel/plain {isect_k / isect_p:.5f}")
    # #3 on the main path's four calls of a sample (phase 2's recorded
    # bounces): each one's time on the card and its plain walk's
    bounce_rows = ib.time_bounces(bunny.packed, bounce_calls)
    for row, (o, d, a, _) in zip(bounce_rows, bounce_calls):
        row["plain_ms"] = time_ms(lambda o=o, d=d, a=a: (
            bk.intersect_packed_plain(bunny.packed, o, d, a, True)),
            PLAIN_REPEATS)
    sph_k = time_ms(run(mk.render_flat_megakernel, demo, demo_cam, MAIN))
    sph_p = time_ms(run(mk.render_flat_fused, demo, demo_cam, MAIN),
                    PLAIN_REPEATS)
    big = dict(width=1920, height=1080, spp=256, max_depth=4)
    sph_big = time_ms(run(mk.render_flat_megakernel, demo, demo_cam, big))
    log(f"[time] {card}: demo 640x360 spp16 d4 kernel {sph_k:.3f} ms "
        f"({mrays(MAIN, sph_k):.1f} Mrays/s), plain {sph_p:.3f} ms "
        f"({mrays(MAIN, sph_p):.1f} Mrays/s), kernel/plain "
        f"{sph_k / sph_p:.4f}")
    log(f"[time] {card}: demo 1920x1080 spp256 d4 kernel {sph_big:.3f} ms "
        f"({mrays(big, sph_big):.1f} Mrays/s)")
    spec_k = time_ms(run(sf.render_flat_spectral_megakernel, cornell,
                         cornell_cam, MAIN))
    spec_p = time_ms(run(sf.render_flat_fused_spectral, cornell,
                         cornell_cam, MAIN), PLAIN_REPEATS)
    # the RGB kernel on the same scene: what the spectral shading costs
    rgb_cornell = time_ms(run(mk.render_flat_megakernel, cornell,
                              cornell_cam, MAIN))
    log(f"[time] {card}: spectral cornell 640x360 spp16 d4 kernel "
        f"{spec_k:.3f} ms ({mrays(MAIN, spec_k):.1f} Mrays/s), plain "
        f"{spec_p:.3f} ms ({mrays(MAIN, spec_p):.2f} Mrays/s), kernel/plain "
        f"{spec_k / spec_p:.5f}; RGB kernel on the same scene "
        f"{rgb_cornell:.3f} ms")
    sbvh_k = time_ms(run(sb.render_flat_spectral_bvh_megakernel, bunny,
                         bunny_cam, BVH_TIMED))
    sbvh_p = time_ms(run(sb.render_flat_spectral_bvh_fused, bunny,
                         bunny_cam, BVH_TIMED), PLAIN_REPEATS)
    sbvh_full = time_ms(run(sb.render_flat_spectral_bvh_megakernel, bunny,
                            bunny_cam, MAIN))
    log(f"[time] {card}: spectral bunny 640x360 spp4 d4 kernel "
        f"{sbvh_k:.3f} ms ({mrays(BVH_TIMED, sbvh_k):.1f} Mrays/s), plain "
        f"{sbvh_p:.3f} ms ({mrays(BVH_TIMED, sbvh_p):.2f} Mrays/s), "
        f"kernel/plain {sbvh_k / sbvh_p:.5f}")
    log(f"[time] {card}: spectral bunny 640x360 spp16 d4 kernel "
        f"{sbvh_full:.3f} ms ({mrays(MAIN, sbvh_full):.1f} Mrays/s)")
    # the superleaf kernels, each beside cuda_bvh on the same call
    mxu_t = {}
    for name, kernel_fn, plain_fn, scene, row_scene, cam in (
            ("bvh_mxu_megakernel", bk.render_flat_bvh_mxu_megakernel,
             mxu_renders["bvh_mxu"][1], bunny_sl, bunny, bunny_cam),
            ("mxu_megakernel", xk.render_flat_mxu_megakernel,
             mxu_renders["mxu"][1], mesh_mxu, mesh, mesh_wide_cam)):
        mxu_t[name] = dict(
            ms=time_ms(run(kernel_fn, scene, cam, BVH_TIMED)),
            plain_ms=time_ms(run(plain_fn, scene, cam, BVH_TIMED),
                             PLAIN_REPEATS),
            full_ms=time_ms(run(kernel_fn, scene, cam, MAIN)),
            cuda_bvh_ms=time_ms(run(bk.render_flat_bvh_megakernel,
                                    row_scene, cam, BVH_TIMED)),
            cuda_bvh_full_ms=time_ms(run(bk.render_flat_bvh_megakernel,
                                         row_scene, cam, MAIN)))
        t_ = mxu_t[name]
        log(f"[time] {card}: {name} 640x360 spp4 d4 kernel {t_['ms']:.3f} "
            f"ms ({mrays(BVH_TIMED, t_['ms']):.1f} Mrays/s), plain "
            f"{t_['plain_ms']:.3f} ms, kernel/plain "
            f"{t_['ms'] / t_['plain_ms']:.5f}; spp16 d4 {t_['full_ms']:.3f} "
            f"ms ({mrays(MAIN, t_['full_ms']):.1f} Mrays/s); cuda_bvh on the "
            f"same calls {t_['cuda_bvh_ms']:.3f} and "
            f"{t_['cuda_bvh_full_ms']:.3f} ms")
    mxu_t["mxu_intersect"] = dict(
        ms=time_ms(lambda: xk.intersect_tile_mxu(bunny_mxu,
                                                 *rays["primary"])),
        plain_ms=time_ms(lambda: xk.intersect_mxu_plain(
            bunny_mxu, *rays["primary"]), PLAIN_REPEATS))
    t_ = mxu_t["mxu_intersect"]
    log(f"[time] {card}: #8 bunny primary rays 640x360 intersect kernel "
        f"{t_['ms']:.4f} ms ({w * h / (t_['ms'] * 1e-3) / 1e6:.1f} Mrays/s), "
        f"plain {t_['plain_ms']:.3f} ms, kernel/plain "
        f"{t_['ms'] / t_['plain_ms']:.5f}; the packed-BVH query on the same "
        f"rays {isect_k:.4f} ms")
    times = (bvh_k, bvh_p, bvh_full, counted_k, counted_full, peak_plain_ms,
             dtype_plain_ms, isect_k, isect_p, sph_k, sph_p, sph_big,
             spec_k, spec_p, rgb_cornell, sbvh_k, sbvh_p, sbvh_full,
             *(x for t_ in mxu_t.values() for x in t_.values()))
    if not all(math.isfinite(x) for x in times):
        raise AssertionError("timing failed")
    for name, k, p in (("bvh_megakernel", bvh_k, bvh_p),
                       ("bvh_intersect", isect_k, isect_p),
                       ("megakernel", sph_k, sph_p),
                       ("spectral_megakernel", spec_k, spec_p),
                       ("spectral_bvh_megakernel", sbvh_k, sbvh_p),
                       *((n_, t_["ms"], t_["plain_ms"])
                         for n_, t_ in mxu_t.items())):
        if k > p:
            log(f"[time] {name} is SLOWER than its plain version")
    # where the wrappers' time goes: the kernel against the small
    # table-packing launches before it, and the card's idle share
    bvh_prof = device_breakdown(run(bk.render_flat_bvh_megakernel, bunny,
                                    bunny_cam, MAIN))
    log_breakdown(card, "bunny 640x360 spp16 d4", bvh_prof)
    sph_prof = device_breakdown(run(mk.render_flat_megakernel, demo,
                                    demo_cam, MAIN))
    log_breakdown(card, "demo 640x360 spp16 d4", sph_prof)
    spec_prof = device_breakdown(run(sf.render_flat_spectral_megakernel,
                                     cornell, cornell_cam, MAIN))
    log_breakdown(card, "spectral cornell 640x360 spp16 d4", spec_prof)
    sbvh_prof = device_breakdown(run(sb.render_flat_spectral_bvh_megakernel,
                                     bunny, bunny_cam, MAIN))
    log_breakdown(card, "spectral bunny 640x360 spp16 d4", sbvh_prof)
    # the host's share of each main-path frame: the wrapper's time (CUDA
    # events) less the device's (torch.profiler), at MAIN
    host_ms = {}
    for name, ms, prof in (("megakernel", sph_k, sph_prof),
                           ("bvh_megakernel", bvh_full, bvh_prof),
                           ("spectral_megakernel", spec_k, spec_prof),
                           ("spectral_bvh_megakernel", sbvh_full,
                            sbvh_prof)):
        host_ms[name] = ms - prof["device_ms_per_call"]
        log(f"[host] {card}: {name} {MAIN_SHAPE}: wrapper {ms:.4f} ms, the "
            f"device {prof['device_ms_per_call']:.4f} ms, the host "
            f"{host_ms[name]:.4f} ms ({host_ms[name] / ms:.3f} of the call)")
    mxu_prof = dict(
        bvh_mxu_megakernel=device_breakdown(run(
            bk.render_flat_bvh_mxu_megakernel, bunny_sl, bunny_cam, MAIN)),
        mxu_megakernel=device_breakdown(run(
            xk.render_flat_mxu_megakernel, mesh_mxu, mesh_wide_cam, MAIN)))
    log_breakdown(card, "#2b bunny 640x360 spp16 d4",
                  mxu_prof["bvh_mxu_megakernel"])
    log_breakdown(card, "#7 mesh 640x360 spp16 d4",
                  mxu_prof["mxu_megakernel"])
    # the adjoint kernel and the step (bench/grad_step.py), and the same
    # for another commit's checkout in a process of its own
    grad_t = gs.measure(device)
    vjp_ms, step_ms = grad_t["vjp_ms"], grad_t["step_ms"]
    vjp_zero_ms, loss_k = grad_t["vjp_zero_cotangent_ms"], grad_t["loss_ms"]
    fwd_ms = grad_t["loss_kernels_ms"].get("spira::grad_loss_forward")
    loss_p = grad_checks[4]["plain_ms_once"]
    for g, ms in step_ms.items():
        log(f"[time] {card}: differentiable step demo 640x360 spp16 d4 "
            f"grad_spp {g}: {ms:.3f} ms ({mrays(MAIN, ms):.1f} Mrays/s)")
    log(f"[time] {card}: adjoint kernel alone, VJP mode 640x360 spp16 d4: "
        f"grad_spp 16 {vjp_ms[16]:.3f} ms (zero cotangent, no gradient "
        f"adds: {vjp_zero_ms:.3f} ms), grad_spp 4 {vjp_ms[4]:.3f} ms; "
        f"loss mode (forward at spp 16 + replay of 16) {loss_k:.3f} ms, its "
        f"forward kernel alone {fwd_ms} ms (torch.profiler; by kernel "
        f"{grad_t['loss_kernels_ms']}), plain version (one call, case q) "
        f"{loss_p:.3f} ms, kernel/plain {loss_k / loss_p:.5f}")
    # the wavefront frame: where its time goes (bench/wavefront_frame.py),
    # in a process of its own (inside this one, after the other phases,
    # the host's dispatch is slower, PERF.md §5)
    proc = subprocess.run(
        [sys.executable, "-m", "spira_tpu_torch.bench.wavefront_frame"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600, check=True)
    wave_t = json.loads(proc.stdout.strip().splitlines()[-1])
    n_isect = MAIN["spp"] * MAIN["max_depth"]
    if wave_t["intersect_launches"] != n_isect:
        raise AssertionError(f"the profiled wavefront frame launched #3 "
                             f"{wave_t['intersect_launches']} times, not "
                             f"{n_isect}")
    wave_t["spectral_wrapper_ms"] = time_ms(
        lambda: sp.render_flat(bunny, bunny_cam, spectral=True, **MAIN), 5)
    wave_t["render_with_cpu_demo_ms"] = time_ms(
        lambda: sp.render_with_cpu(demo, demo_cam, w, h, **main_args), 5)
    log(f"[wavefront] {card}: bunny render_flat {MAIN_SHAPE} in a process "
        f"of its own (bench/wavefront_frame.py): wrapper "
        f"{wave_t['wrapper_ms']:.3f} ms (median of 5), on the card "
        f"{wave_t['device_ms']:.3f} ms (one profiled call), idle share "
        f"{wave_t['idle_share']} of the wrapper, "
        f"{wave_t['idle_share_profiled']} of the profiled call's "
        f"{wave_t['profiled_wall_ms']:.3f} ms")
    log(f"[wavefront] {card}: #3 {wave_t['intersect_ms']} ms a frame on the "
        f"card over {wave_t['intersect_launches']} launches (profiled), "
        f"{wave_t['intersect_ms_per_launch']} ms a launch, "
        f"{wave_t['intersect_share']} of the device time; device operations "
        f"a frame {wave_t['device_ops']}; top kernels (ms) "
        f"{wave_t['top_kernels_ms']}")
    log(f"[wavefront] {card}: the threefry draws alone "
        f"{wave_t['rng_ms']:.3f} ms, {wave_t['rng_share']:.4f} of the "
        f"wrapper; in this process: spectral render_flat "
        f"{wave_t['spectral_wrapper_ms']:.3f} ms, render_with_cpu demo "
        f"{MAIN_SHAPE} (tone map and host copy included) "
        f"{wave_t['render_with_cpu_demo_ms']:.3f} ms")
    # the mesh step (bench/grad_step.py --mesh), in a process of its own
    proc = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "spira_tpu_torch", "bench", "grad_step.py"),
         "--mesh"], capture_output=True, text=True, timeout=600, check=True)
    mesh_t = json.loads(proc.stdout.strip().splitlines()[-1])
    for r in mesh_t["steps"]:
        n3 = mesh_replay_launches(r["grad_spp"], MAIN["max_depth"])
        log(f"[mesh_step] {card}: bunny render_flat_hybrid_grad_mesh "
            f"{MAIN_SHAPE} grad_spp {r['grad_spp']} "
            f"{'spectral, d albedo_spd' if r['spectral'] else 'RGB, d albedo'}"
            f" (bench/grad_step.py --mesh, a process of its own): step "
            f"{r['step_ms']:.3f} ms (median of {len(r['step_ms_runs'])}: "
            f"{[round(x, 3) for x in r['step_ms_runs']]}), forward "
            f"{r['forward_ms']:.3f} ms, backward {r['backward_ms']:.3f} ms; "
            f"launches a step {r['launches_per_step']}; on the card "
            f"{r['device_ms']:.3f} ms (one profiled step of "
            f"{r['profiled_wall_ms']:.3f} ms), idle share "
            f"{r['idle_share']:.4f} of the step; device operations "
            f"{r['device_ops']}; kernels {r['kernel_launches_profiled']}; "
            f"peak memory above the scene: the step "
            f"{r['peak_mb_step']:.1f} MiB, the backward's replay "
            f"{r['peak_mb_replay']:.1f} MiB; the replay by hand "
            f"{r['replay_ms']:.3f} ms; top kernels "
            f"(ms) {r['top_kernels_ms']}")
        if (r["launches_per_step"] != dict(forward=1, intersect=n3)
                or not r["grad_finite"] or not r["grad_abs_max"] > 0
                or not all(math.isfinite(r[k]) for k in (
                    "step_ms", "forward_ms", "backward_ms"))):
            raise AssertionError(f"the timed mesh step is wrong: {r}")
    parent_t = parent_frames = this_frames = bounce_runs = None
    superleaf_runs = None
    if args.parent:
        here = os.path.dirname(os.path.abspath(__file__))

        def bench(script, root):
            proc = subprocess.run(
                [sys.executable, os.path.join(here, "spira_tpu_torch",
                                              "bench", script),
                 "--root", root],
                capture_output=True, text=True, timeout=600, check=True)
            return json.loads(proc.stdout.strip().splitlines()[-1])

        parent_t = bench("grad_step.py", args.parent)
        log(f"[time] {card}: the parent's ({args.parent}) adjoint kernel: "
            f"VJP grad_spp 16 {parent_t['vjp_ms']['16']:.3f} ms (zero "
            f"cotangent {parent_t['vjp_zero_cotangent_ms']:.3f}), grad_spp 4 "
            f"{parent_t['vjp_ms']['4']:.3f} ms, loss mode "
            f"{parent_t['loss_ms']:.3f} ms; step {parent_t['step_ms']}; "
            f"ptxas {parent_t['ptxas']['grad_megakernel']}")
        # the frames (#1, #2, #2b, #3, #4, #5) of both commits, each run
        # in its own process: parent, this, this, parent
        frames = [bench("mesh_frame.py", root)
                  for root in (args.parent, here, here, args.parent)]
        parent_frames, this_frames = frames[::3], frames[1:3]
        for f in frames:
            log(f"[time] {card}: frames of {f['root']} (bench/mesh_frame.py): "
                + "; ".join(
                    f"{k} wrapper {r['wrapper_ms']:.4f} ms, on the card "
                    f"{r['device_ms']:.4f} {r['kernels_ms']}, host "
                    f"{r['host_ms']:.4f} ({r['host_share']:.3f} of the call), "
                    f"device ops {r['device_ops']}"
                    + (f", {r['blocks_per_sm']} blocks an SM, "
                       f"{r['waves']:.3f} waves" if "waves" in r else "")
                    for k, r in f["frames"].items())
                + f"; ptxas {f['ptxas']}")

        def digests(f):
            return f["case_digests"], {k: r["digest"]
                                       for k, r in f["frames"].items()}

        same = all(digests(f) == digests(frames[0]) for f in frames)
        log(f"[compare] frames, cases a-c, g-i, #7 and the wavefront frames "
            f"(render_flat, RGB and spectral): every image of this tree "
            f"equal to the parent's to the bit (SHA-256): {same}")
        if not same:
            raise AssertionError("a frame or case renders differently from "
                                 "the parent's")
        # #3 on the main path's four calls of a sample, both commits, each
        # run in its own process: parent, this, this, parent
        bounce_runs = [bench("intersect_bounces.py", root)
                       for root in (args.parent, here, here, args.parent)]
        for f in bounce_runs:
            log(f"[bounce] {card}: #3 of {f['root']} "
                f"(bench/intersect_bounces.py): "
                + "; ".join(f"bounce {r['bounce']} alive {r['alive']:.6f} "
                            f"{r['ms']:.4f} ms, on the card "
                            f"{r['kernels_ms']}" for r in f["bounces"])
                + f"; a sample {f['sample_ms']:.4f} ms; ptxas "
                f"{f['ptxas']}")
        same = all([(r["inputs"], r["outputs"]) for r in f["bounces"]]
                   == [(r["inputs"], r["outputs"])
                       for r in bounce_runs[0]["bounces"]]
                   for f in bounce_runs)
        log(f"[compare] #3 on a sample's four calls: the inputs and every "
            f"output of this tree equal to the parent's (SHA-256): {same}")
        if not same:
            raise AssertionError("#3 differs from the parent's on the main "
                                 "path's bounces")
        # the superleaf kernels (#7, #8, #2b) of both commits, each run in
        # its own process: parent, this, this, parent
        superleaf_runs = [bench("superleaf.py", root)
                          for root in (args.parent, here, here, args.parent)]
        for f in superleaf_runs:
            log(f"[superleaf] {card}: {f['root']} (bench/superleaf.py): "
                + "; ".join(f"{k} {r['ms']:.4f} ms"
                            for k, r in f["frames"].items())
                + f"; routes {f['routes']}; ptxas {f['ptxas']}")
        same = all({k: r["digest"] for k, r in f["frames"].items()}
                   == {k: r["digest"]
                       for k, r in superleaf_runs[0]["frames"].items()}
                   for f in superleaf_runs)
        log(f"[compare] #7, #8 and #2b: every output of this tree equal to "
            f"the parent's (SHA-256): {same}")
        if not same:
            raise AssertionError("a superleaf kernel's output differs from "
                                 "the parent's")
    step_prof = device_breakdown(lambda: step(albedo0, 0, MAIN["spp"]))
    log_breakdown(card, "differentiable step 640x360 spp16 d4 exact "
                  "replay", step_prof)
    if not all(math.isfinite(x) for x in (*step_ms.values(),
                                          *vjp_ms.values(), vjp_zero_ms,
                                          loss_k, fwd_ms or math.nan)):
        raise AssertionError("timing failed")

    # ---- each kernel's bound, from the work this run's inputs need
    n_px = w * h
    sph_work = count_work(mk, "make_brute_intersect",
                          run(mk.render_flat_fused, demo, demo_cam, MAIN))
    # the first 4 samples of the same render: the grad_spp 4 replay's
    sph4_work = count_work(mk, "make_brute_intersect",
                           run(mk.render_flat_fused, demo, demo_cam,
                               dict(MAIN, spp=4)))
    # #2's inventory from its counting build; count_work's plain count of
    # the same render must agree with it
    bvh_work = dict(segments=counted["traversals"], hits=counted["hits"],
                    pops=counted["pops"], leaf_tris=counted["leaf_tris"],
                    blocks=0)
    bvh_plain_work = count_work(bk, "make_packed_intersect",
                                run(bk.render_flat_bvh_fused, bunny,
                                    bunny_cam, BVH_TIMED))
    log(f"[work] #2 bunny spp4: counting kernel {bvh_work}, count_work on "
        f"the plain version {bvh_plain_work}")
    if bvh_work != bvh_plain_work:
        raise AssertionError("#2: the counting kernel's inventory differs "
                             "from count_work's")
    spec_work = count_work(sf, "make_brute_intersect_spectral",
                           run(sf.render_flat_fused_spectral, cornell,
                               cornell_cam, MAIN))
    sbvh_work = count_work(sb, "make_packed_intersect_spectral",
                           run(sb.render_flat_spectral_bvh_fused, bunny,
                               bunny_cam, BVH_TIMED))
    # the ranking's shape, MAIN: #2's work from its counting build at spp
    # 16, the other path tracers' from their plain versions at MAIN
    ctr16 = counted_checks["counters_640x360_spp16_d4"]
    bvh16_work = dict(segments=ctr16["traversals"], hits=ctr16["hits"],
                      pops=ctr16["pops"], leaf_tris=ctr16["leaf_tris"],
                      blocks=0)
    sbvh16_work = count_work(sb, "make_packed_intersect_spectral",
                             run(sb.render_flat_spectral_bvh_fused, bunny,
                                 bunny_cam, MAIN))
    bounce_work = [count_work(None, None, lambda o=o, d=d, a=a: (
        bk.intersect_packed_plain(bunny.packed, o, d, a, True)))
        for o, d, a, _ in bounce_calls]
    sl_lanes = bunny_sl.wide.lanes.offsets.diff()
    bvh_mxu_work = count_work(bk, "make_packed_intersect", run(
        mxu_renders["bvh_mxu"][1], bunny_sl, bunny_cam, BVH_TIMED),
        block_lanes=sl_lanes, block_groups=bunny_sl.wide.groups)
    mesh_lanes = mesh_mxu.wide.lanes.n_lanes
    mxu_work = count_work(xk, "make_mxu_stream_intersect", run(
        mxu_renders["mxu"][1], mesh_mxu, mesh_wide_cam, BVH_TIMED),
        stream_blocks=xk.n_blocks(mesh_mxu.wide), stream_lanes=mesh_lanes)
    bvh_mxu16_work = count_work(bk, "make_packed_intersect", run(
        mxu_renders["bvh_mxu"][1], bunny_sl, bunny_cam, MAIN),
        block_lanes=sl_lanes, block_groups=bunny_sl.wide.groups)
    mxu16_work = count_work(xk, "make_mxu_stream_intersect", run(
        mxu_renders["mxu"][1], mesh_mxu, mesh_wide_cam, MAIN),
        stream_blocks=xk.n_blocks(mesh_mxu.wide), stream_lanes=mesh_lanes)
    # the stream tests every block's real lanes for every ray: no walk to
    # count
    mxu_isect_work = dict(segments=w * h, hits=0, pops=0, leaf_tris=0,
                          blocks=w * h * xk.n_blocks(bunny_mxu),
                          lanes=w * h * bunny_mxu.lanes.n_lanes)
    # #2b's counting build on the same frames: its image the uncounted
    # kernel's, its counts the plain walk's (count_work: the lanes tested
    # are the real lanes of the groups entered; the blocks' real lanes
    # beside them)
    mxu_counts = {}
    for label, shape, work in (("spp4", BVH_TIMED, bvh_mxu_work),
                               ("spp16", MAIN, bvh_mxu16_work)):
        img_c, ctr = bk.render_bvh_with_counters(bunny_sl, bunny_cam,
                                                 mxu_leaf=True, **shape)
        ref = bk.render_flat_bvh_mxu_megakernel(bunny_sl, bunny_cam, **shape)
        torch.cuda.synchronize()
        kernel_work = dict(segments=ctr["traversals"], pops=ctr["pops"],
                           blocks=ctr["leaf_visits"],
                           lanes_tested=ctr["leaf_tris"], hits=ctr["hits"])
        plain_work = {k: work[k] for k in kernel_work}
        mxu_counts[label] = dict(kernel=kernel_work, plain=dict(
            plain_work, real_lanes=work["lanes"], groups=work["groups"]),
            image_bit_equal=torch.equal(img_c, ref))
        walks = kernel_work["segments"]
        tested = kernel_work["lanes_tested"]
        log(f"[2b] {card}: #2b bunny 640x360 {label} d4, per walk: "
            f"{kernel_work['blocks'] / walks:.4f} blocks visited, "
            f"{work['groups'] / walks:.4f} group boxes tested, "
            f"{tested / walks:.3f} lanes tested and "
            f"{(work['lanes'] - tested) / walks:.3f} skipped of "
            f"{work['lanes'] / walks:.3f} real lanes "
            f"({tested / kernel_work['blocks']:.3f} of "
            f"{work['lanes'] / kernel_work['blocks']:.3f} a block), "
            f"{kernel_work['pops'] / walks:.4f} records popped; the "
            f"counting kernel {kernel_work}, the plain count (count_work) "
            f"{mxu_counts[label]['plain']}; its image bit-equal to the "
            f"uncounted kernel's {mxu_counts[label]['image_bit_equal']}")
        if kernel_work != plain_work or not mxu_counts[label][
                "image_bit_equal"]:
            raise AssertionError(f"#2b's counting build at {label} differs "
                                 "from the plain count or the kernel")
    log(f"[work] on the timed inputs: demo {sph_work}, bunny spp4 "
        f"{bvh_work}, #3 on a sample's bounces {bounce_work}, spectral "
        f"cornell {spec_work}, spectral bunny spp4 {sbvh_work}, #2b bunny "
        f"spp4 {bvh_mxu_work}, #7 mesh spp4 {mxu_work}, #8 bunny primary rays "
        f"{mxu_isect_work}; at 640x360 spp16 d4: bunny (counting build) "
        f"{bvh16_work}, spectral bunny {sbvh16_work}, #2b bunny "
        f"{bvh_mxu16_work}, #7 mesh {mxu16_work}")
    out_bytes = 12 * n_px
    bvh_tables = table_bytes(bunny.packed.pairs, bunny.packed.tri_rows)

    demo_tables = table_bytes(*mk.pack_tables(demo, demo_cam))
    n_bunny_sph = bunny.spheres.count
    sph_units = sol.path_units(sph_work, n_px * MAIN["spp"],
                               demo.spheres.count, 0)
    sph4_units = sol.path_units(sph4_work, n_px * 4, demo.spheres.count, 0)
    bounds = dict(
        megakernel=sol_bound(sph_units, demo_tables + out_bytes, rates),
        bvh_megakernel=sol_bound(
            sol.path_units(bvh_work, n_px * BVH_TIMED["spp"], n_bunny_sph, 0,
                           bvh=True, form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        spectral_megakernel=sol_bound(
            sol.path_units(spec_work, n_px * MAIN["spp"],
                           cornell.spheres.count, cornell.triangles.count,
                           spectral=True), out_bytes, rates),
        spectral_bvh_megakernel=sol_bound(
            sol.path_units(sbvh_work, n_px * BVH_TIMED["spp"], n_bunny_sph,
                           0, spectral=True, bvh=True,
                           form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        # the four path tracers at MAIN, the ranking's shape
        bvh_megakernel_16=sol_bound(
            sol.path_units(bvh16_work, n_px * MAIN["spp"], n_bunny_sph, 0,
                           bvh=True, form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        spectral_bvh_megakernel_16=sol_bound(
            sol.path_units(sbvh16_work, n_px * MAIN["spp"], n_bunny_sph, 0,
                           spectral=True, bvh=True, form=bunny.packed.form),
            bvh_tables + out_bytes, rates),
        # #2b: the lanes it tests (the groups entered) and the boxes;
        # beside it every real lane of the blocks visited, and all 128
        bvh_mxu_megakernel_16=sol_bound(
            sol.path_units(tested_lanes(bvh_mxu16_work), n_px * MAIN["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs, bunny_sl.wide.groups)
            + lane_bytes(bunny_sl.wide) + out_bytes, rates),
        bvh_mxu_megakernel_16_real_lanes=sol_bound(
            sol.path_units(real_lanes(bvh_mxu16_work), n_px * MAIN["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs) + lane_bytes(bunny_sl.wide)
            + out_bytes, rates),
        bvh_mxu_megakernel_16_all_lanes=sol_bound(
            sol.path_units(all_lanes(bvh_mxu16_work), n_px * MAIN["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs) + coeff_bytes(bunny_sl.wide)
            + out_bytes, rates),
        mxu_megakernel_16=sol_bound(
            sol.path_units(mxu16_work, n_px * MAIN["spp"],
                           mesh_mxu.spheres.count, 0),
            lane_bytes(mesh_mxu.wide) + out_bytes, rates),
        # the same work had every block's 128 lanes been tested
        mxu_megakernel_16_all_lanes=sol_bound(
            sol.path_units(all_lanes(mxu16_work), n_px * MAIN["spp"],
                           mesh_mxu.spheres.count, 0),
            coeff_bytes(mesh_mxu.wide) + out_bytes, rates),
        # loss mode at exact replay: the forward, the replay's forward,
        # and the reverse sweep of every replayed hit; bytes: tables,
        # target, gradient tables
        grad_megakernel=sol_bound(
            dict({u: 2 * n for u, n in sph_units.items()},
                 adjoint_hit=sph_work["hits"]),
            2 * demo_tables + out_bytes + 8, rates),
        # VJP mode (the step's backward): the replay's forward once and the
        # reverse sweep of every replayed hit; bytes: tables, cotangent,
        # gradient tables
        grad_vjp_16=sol_bound(dict(sph_units, adjoint_hit=sph_work["hits"]),
                              2 * demo_tables + out_bytes, rates),
        grad_vjp_4=sol_bound(dict(sph4_units, adjoint_hit=sph4_work["hits"]),
                             2 * demo_tables + out_bytes, rates),
        # loss mode's forward: #1's work; bytes: tables, target, cotangent,
        # the loss
        grad_loss_forward=sol_bound(sph_units,
                                    demo_tables + 2 * out_bytes + 8, rates),
        bvh_mxu_megakernel=sol_bound(
            sol.path_units(tested_lanes(bvh_mxu_work),
                           n_px * BVH_TIMED["spp"], n_bunny_sph, 0,
                           bvh=True),
            table_bytes(bunny_sl.wide.pairs, bunny_sl.wide.groups)
            + lane_bytes(bunny_sl.wide) + out_bytes, rates),
        bvh_mxu_megakernel_real_lanes=sol_bound(
            sol.path_units(real_lanes(bvh_mxu_work), n_px * BVH_TIMED["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs) + lane_bytes(bunny_sl.wide)
            + out_bytes, rates),
        bvh_mxu_megakernel_all_lanes=sol_bound(
            sol.path_units(all_lanes(bvh_mxu_work), n_px * BVH_TIMED["spp"],
                           n_bunny_sph, 0, bvh=True),
            table_bytes(bunny_sl.wide.pairs) + coeff_bytes(bunny_sl.wide)
            + out_bytes, rates),
        mxu_megakernel=sol_bound(
            sol.path_units(mxu_work, n_px * BVH_TIMED["spp"],
                           mesh_mxu.spheres.count, 0),
            lane_bytes(mesh_mxu.wide) + out_bytes, rates),
        mxu_megakernel_all_lanes=sol_bound(
            sol.path_units(all_lanes(mxu_work), n_px * BVH_TIMED["spp"],
                           mesh_mxu.spheres.count, 0),
            coeff_bytes(mesh_mxu.wide) + out_bytes, rates),
        # bytes: the rays in, t, normal and material id out, the records
        # and the payload
        mxu_intersect=sol_bound(sol.walk_units(mxu_isect_work),
                                lane_bytes(bunny_mxu) + n_px * (24 + 20),
                                rates),
        mxu_intersect_all_lanes=sol_bound(
            sol.walk_units(all_lanes(mxu_isect_work)),
            coeff_bytes(bunny_mxu) + n_px * (24 + 20), rates),
        # the probes: their counted operations (one ALU instruction each,
        # in separate mode and in float32) at the issue rate; bytes: one
        # float32 in and out an element
        vpu_peak=price(dict(alu=vp.ops_per_launch("separate",
                                                  probe["n_peak"]),
                            bytes=8 * probe["n_peak"]), rates),
        vpu_dtype=price(dict(alu=pp.flops_per_launch(probe["n_dtype"]),
                             bytes=8 * probe["n_dtype"]), rates),
    )
    # #3 on each of a sample's four calls: the plain walk's work on that
    # call's live rays; bytes: the tables, the mask, the live rays in, and
    # t, normal, material id and slot out for every ray.  The four calls
    # run one after another, so their bound is the sum of theirs.
    for b, (work, row, call) in enumerate(zip(bounce_work, bounce_rows,
                                              bounce_calls)):
        live = int(call[2].sum())
        bounds[f"bvh_intersect_bounce{b}"] = sol_bound(
            dict(ray=live, **sol.walk_units(work, bunny.packed.form)),
            bvh_tables + row["rays"] * (1 + 24) + live * 24, rates)
    bounds["bvh_intersect"] = sum_bounds(
        [bounds[f"bvh_intersect_bounce{b}"] for b in range(len(bounce_rows))])
    log(f"[bound] {card}: priced by utils/sol.py ({rates.source}): ALU "
        f"at the issue rate {rates.alu_per_s:.4g} instructions/s, special "
        f"functions at weights "
        f"{({k: round(v, 2) for k, v in rates.weights.items()})} ALU "
        f"instructions over the same rate, memory "
        f"{rates.hbm_bytes_per_s:.3g} B/s; beside each, for the record, the "
        f"data-sheet bound (every operation over "
        f"{sol.DATASHEET_F32_PER_S:.3g} FLOP/s)")
    for name, b in bounds.items():
        log(f"[bound] {card}: {name} {b['bound_ms']:.4f} ms, by "
            f"{b['bound_term']} (terms ms "
            f"{({k: round(v, 5) for k, v in b['bound_terms_ms'].items()})}"
            f"); data-sheet bound {b['datasheet_bound_ms']:.4f} ms")
    for label, ms, name, real in (
            ("spp4", mxu_t["bvh_mxu_megakernel"]["ms"], "bvh_mxu_megakernel",
             bounds["bvh_mxu_megakernel_real_lanes"]),
            ("spp16", mxu_t["bvh_mxu_megakernel"]["full_ms"],
             "bvh_mxu_megakernel_16",
             bounds["bvh_mxu_megakernel_16_real_lanes"])):
        log(f"[2b] {card}: #2b bunny 640x360 {label} d4: {ms:.4f} ms "
            f"(wrapper, CUDA events), bound {bounds[name]['bound_ms']:.4f} "
            f"ms by {bounds[name]['bound_term']} over the lanes it tests "
            f"({sol.sol_pct(bounds[name]['bound_ms'], ms):.3f}% of it); "
            f"over every real lane of the blocks it visits "
            f"{real['bound_ms']:.4f} ms "
            f"({sol.sol_pct(real['bound_ms'], ms):.3f}%)")
    for b, row in enumerate(bounce_rows):
        bd = bounds[f"bvh_intersect_bounce{b}"]
        log(f"[bounce] {card}: #3 on render_flat's bounce {b} rays, bunny "
            f"{MAIN_SHAPE} sample 0: {row['rays']} rays, alive "
            f"{row['alive']:.6f}, {row['ms']:.4f} ms (CUDA events around "
            f"{ib.RUN} calls, median of {timing.REPEATS}), on the card by "
            f"kernel {row['kernels_ms']} (torch.profiler), bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_term']}, plain "
            f"{row['plain_ms']:.3f} ms")
    log(f"[bounce] {card}: #3 on a sample's four calls: "
        f"{sum(r['ms'] for r in bounce_rows):.4f} ms, bound "
        f"{bounds['bvh_intersect']['bound_ms']:.4f} ms")

    # the walks' bytes a frame at MAIN, from the counted work: a popped
    # pair record 64 bytes, a leaf triangle 48 (three float4), a segment's
    # winner 16 (its material row; counted per hit segment, spheres too),
    # and the rate they imply over the kernel's time on the card: a
    # diagnostic beside the bound, not a term of it
    walk_bytes = {}
    for name, work, prof in (("bvh_megakernel", bvh16_work, bvh_prof),
                             ("spectral_bvh_megakernel", sbvh16_work,
                              sbvh_prof)):
        nbytes = (64 * work["pops"] + 48 * work["leaf_tris"]
                  + 16 * work["hits"])
        on_card = prof["kernels_ms_per_call"].get(f"spira::{name}")
        walk_bytes[name] = dict(bytes=nbytes, card_ms=on_card,
                                tb_per_s=(nbytes / (on_card * 1e-3) / 1e12
                                          if on_card else None))
        log(f"[work] {card}: {name} {MAIN_SHAPE}: the walk touches "
            f"{nbytes} bytes a frame ({work['pops']} pops x 64 + "
            f"{work['leaf_tris']} leaf triangles x 48 + {work['hits']} "
            f"winners x 16), {walk_bytes[name]['tb_per_s']} TB/s over "
            f"{on_card} ms on the card; bound "
            f"{bounds[name + '_16']['bound_ms']:.4f} ms")

    def bound_keys(name):
        b = bounds[name]
        # no single PyTorch call computes a path tracer, a BVH walk, its
        # adjoint or the probes' register chains
        return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None, bound_term=b["bound_term"],
                    bound_terms_ms=b["bound_terms_ms"],
                    datasheet_bound_ms=b["datasheet_bound_ms"])

    def frame_rows(runs, *names):
        """Frames ``names`` of each bench/mesh_frame.py run in ``runs``."""
        return None if runs is None else [
            dict(root=f["root"], ptxas=f["ptxas"],
                 **{n: f["frames"][n] for n in names}) for f in runs]

    def superleaf_rows(*names):
        """Calls ``names`` of each bench/superleaf.py run (parent, this,
        this, parent), with ``--parent``."""
        return None if superleaf_runs is None else [
            dict(root=f["root"], ptxas=f["ptxas"],
                 **{n: f["frames"][n] for n in names})
            for f in superleaf_runs]

    brute_rgb = ("megakernel", "megakernel_1920x1080_spp256")
    brute_spectral = ("spectral_megakernel",
                      "spectral_megakernel_1920x1080_spp256")
    mesh = ("bvh_megakernel", "spectral_bvh_megakernel",
            "bvh_mxu_megakernel", "bvh_intersect")
    kernels = [
        {
            "name": "megakernel",
            "route": "cuda",
            **bound_keys("megakernel"),
            "source": "spira_tpu_torch/csrc/megakernel.cu",
            "replaces": "spira_tpu/kernels/megakernel.py:504",
            "launches": launches["megakernel"],
            "max_abs_err": sphere_checks[1]["max_abs_err"],
            "ms": sph_k,
            "plain_ms": sph_p,
            "shape": "demo 640x360 spp16 d4",
            "ms_1920x1080_spp256": sph_big,
            "profile_640x360_spp16_d4": sph_prof,
            "host_ms": host_ms["megakernel"],
            "parent_frames": frame_rows(parent_frames, *brute_rgb),
            "this_frames": frame_rows(this_frames, *brute_rgb),
            "checks": sphere_checks,
            "ptxas": ptxas.get("megakernel", []),
        },
        {
            "name": "bvh_megakernel",
            "route": "cuda",
            **bound_keys("bvh_megakernel"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:1036",
            "launches": launches["bvh_megakernel"],
            "max_abs_err": bvh_checks[1]["max_abs_err"],
            "ms": bvh_k,
            "plain_ms": bvh_p,
            "shape": "bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": bvh_full,
            "mrays_640x360_spp16_d4": mrays(MAIN, bvh_full),
            "profile_640x360_spp16_d4": bvh_prof,
            "host_ms": host_ms["bvh_megakernel"],
            "bound_ms_640x360_spp16_d4": bounds["bvh_megakernel_16"][
                "bound_ms"],
            "rank_ms_bound_ms": (bvh_full,
                                 bounds["bvh_megakernel_16"]["bound_ms"],
                                 MAIN_SHAPE),
            "walk_bytes_640x360_spp16_d4": walk_bytes["bvh_megakernel"],
            "parent_frames": frame_rows(parent_frames, *mesh),
            "this_frames": frame_rows(this_frames, *mesh),
            "checks": bvh_checks,
            "ptxas": ptxas.get("bvh_megakernel", []),
            "counted_entry": "spira_bvh_megakernel_render_counted",
            "counted_launches": launches["bvh_counted"],
            "counted_ms": counted_k,
            "counted_ms_640x360_spp16_d4": counted_full,
            "counted_ptxas": ptxas.get("bvh_megakernel_counted", []),
            "counted_checks": counted_checks,
        },
        {
            "name": "bvh_intersect",
            "route": "cuda",
            **bound_keys("bvh_intersect"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:1134",
            "launches": launches["bvh_intersect"],
            "max_abs_err": max(c["max_abs_err"] for c in bounce_checks),
            # the main path's four calls of a sample, one a bounce
            "ms": sum(r["ms"] for r in bounce_rows),
            "plain_ms": sum(r["plain_ms"] for r in bounce_rows),
            "shape": (f"render_flat's four calls of sample 0, bunny "
                      f"{MAIN_SHAPE}"),
            "bounces": [dict(r, bound=bounds[f"bvh_intersect_bounce{b}"])
                        for b, r in enumerate(bounce_rows)],
            # with --parent: bench/intersect_bounces.py on the parent,
            # this tree, this tree, the parent
            "parent_this_bounces": bounce_runs,
            "primary_rays_ms": isect_k,
            "primary_rays_plain_ms": isect_p,
            "primary_rays_max_abs_err": isect_checks[1]["max_abs_err"],
            # the main path that launches it: render_flat, one launch a
            # bounce; ranked by its time a launch there (torch.profiler)
            # against the mean of a sample's four calls' bounds
            "rank_ms_bound_ms": (
                wave_t["intersect_ms_per_launch"],
                bounds["bvh_intersect"]["bound_ms"] / len(bounce_rows),
                f"a launch in render_flat, bunny {MAIN_SHAPE}"),
            "wavefront_frame": wave_t,
            # the mesh step: its backward's replay launches #3
            "mesh_step": mesh_t,
            "mesh_step_runs": mesh_runs,
            "checks": isect_checks + wavefront_checks + mesh_grad_checks,
        },
        {
            "name": "spectral_megakernel",
            "route": "cuda",
            **bound_keys("spectral_megakernel"),
            "source": "spira_tpu_torch/csrc/spectral_megakernel.cu",
            "replaces": "spira_tpu/kernels/spectral_fused.py:650",
            "launches": launches["spectral_megakernel"],
            "max_abs_err": spectral_checks[2]["max_abs_err"],
            "ms": spec_k,
            "plain_ms": spec_p,
            "shape": "spectral cornell 640x360 spp16 d4",
            "rgb_kernel_ms_same_scene": rgb_cornell,
            "profile_640x360_spp16_d4": spec_prof,
            "host_ms": host_ms["spectral_megakernel"],
            "parent_frames": frame_rows(parent_frames, *brute_spectral),
            "this_frames": frame_rows(this_frames, *brute_spectral),
            "checks": spectral_checks,
            "ptxas": ptxas.get("spectral_megakernel", []),
        },
        {
            "name": "spectral_bvh_megakernel",
            "route": "cuda",
            **bound_keys("spectral_bvh_megakernel"),
            "source": "spira_tpu_torch/csrc/spectral_megakernel.cu",
            "replaces": "spira_tpu/kernels/spectral_bvh.py:155",
            "launches": launches["spectral_bvh_megakernel"],
            "max_abs_err": spectral_bvh_checks[1]["max_abs_err"],
            "ms": sbvh_k,
            "plain_ms": sbvh_p,
            "shape": "spectral bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": sbvh_full,
            "mrays_640x360_spp16_d4": mrays(MAIN, sbvh_full),
            "profile_640x360_spp16_d4": sbvh_prof,
            "host_ms": host_ms["spectral_bvh_megakernel"],
            "bound_ms_640x360_spp16_d4": bounds[
                "spectral_bvh_megakernel_16"]["bound_ms"],
            "rank_ms_bound_ms": (
                sbvh_full, bounds["spectral_bvh_megakernel_16"]["bound_ms"],
                MAIN_SHAPE),
            "walk_bytes_640x360_spp16_d4": walk_bytes[
                "spectral_bvh_megakernel"],
            "checks": spectral_bvh_checks,
            "ptxas": ptxas.get("spectral_bvh_megakernel", []),
        },
        {
            "name": "grad_megakernel",
            "route": "cuda",
            **bound_keys("grad_megakernel"),
            "source": "spira_tpu_torch/csrc/grad_megakernel.cu",
            "replaces": "spira_tpu/kernels/grad_megakernel.py:57",
            "launches": launches["grad_megakernel"],
            "max_abs_err": max(c["max_abs_err"] for c in grad_checks),
            "ms": loss_k,
            "plain_ms": loss_p,
            "shape": "loss mode, demo 640x360 spp16 d4, exact replay",
            "vjp_ms_grad_spp16": vjp_ms[16],
            "vjp_ms_grad_spp4": vjp_ms[4],
            "vjp_ms_grad_spp16_zero_cotangent": vjp_zero_ms,
            "vjp_bound_ms_grad_spp16": bounds["grad_vjp_16"]["bound_ms"],
            "vjp_bound_ms_grad_spp4": bounds["grad_vjp_4"]["bound_ms"],
            "vjp_share_of_bound_pct_grad_spp16": sol.sol_pct(
                bounds["grad_vjp_16"]["bound_ms"], vjp_ms[16]),
            "vjp_share_of_bound_pct_grad_spp4": sol.sol_pct(
                bounds["grad_vjp_4"]["bound_ms"], vjp_ms[4]),
            "vjp_bound_terms_ms_grad_spp16": (
                bounds["grad_vjp_16"]["bound_terms_ms"]),
            # the step takes VJP mode at grad_spp 16: the ranking's time
            "rank_ms_bound_ms": (vjp_ms[16],
                                 bounds["grad_vjp_16"]["bound_ms"],
                                 f"VJP grad_spp 16, {MAIN_SHAPE}"),
            "parent": parent_t,
            "step_ms_grad_spp16": step_ms[16],
            "step_ms_grad_spp4": step_ms[4],
            "step_mrays_grad_spp16": mrays(MAIN, step_ms[16]),
            "step_mrays_grad_spp4": mrays(MAIN, step_ms[4]),
            "step_profile_640x360_spp16_d4": step_prof,
            "step_runs": step_runs,
            "ptxas": ptxas.get("grad_vjp", []),
            "checks": grad_checks,
            "finite_differences": fd_checks,
        },
        {
            "name": "grad_loss_forward",
            "route": "cuda",
            **bound_keys("grad_loss_forward"),
            "source": "spira_tpu_torch/csrc/grad_megakernel.cu",
            "replaces": "spira_tpu/kernels/grad_megakernel.py:57",
            "launches": launches["grad_loss_forward"],
            "max_abs_err": loss_forward_check["max_abs_err"],
            "ms": fwd_ms,
            # the plain forward at the same shape (the render the MSE is
            # taken of)
            "plain_ms": sph_p,
            "shape": "loss mode's forward, demo 640x360 spp16 d4 "
                     "(torch.profiler, in the loss-mode call)",
            "megakernel_ms_on_card": sph_prof["kernels_ms_per_call"].get(
                "spira::megakernel"),
            "ptxas": ptxas.get("grad_loss_forward", []),
            "checks": [loss_forward_check],
        },
        {
            "name": "mxu_megakernel",
            "route": "cuda",
            **bound_keys("mxu_megakernel"),
            "source": "spira_tpu_torch/csrc/mxu_megakernel.cu",
            "replaces": "spira_tpu/kernels/mxu_megakernel.py:205",
            "launches": launches["mxu_megakernel"],
            "max_abs_err": max(c["max_abs_err"] for e, c in mxu_checks
                               if e != "bvh_mxu"),
            "ms": mxu_t["mxu_megakernel"]["ms"],
            "routes_main_path": main_routes,
            "routes_by_case": {c["case"]: c["route"] for e, c in mxu_checks
                               if e != "bvh_mxu"},
            "bound_ms_128_lanes": bounds["mxu_megakernel_all_lanes"][
                "bound_ms"],
            "bound_ms_128_lanes_640x360_spp16_d4": bounds[
                "mxu_megakernel_16_all_lanes"]["bound_ms"],
            "real_lanes": mesh_lanes,
            "superleaf_runs": superleaf_rows("mxu_megakernel_spp4",
                                             "mxu_megakernel_spp16"),
            "plain_ms": mxu_t["mxu_megakernel"]["plain_ms"],
            "shape": "mesh (1,600 triangles) 640x360 spp4 d4",
            "ms_640x360_spp16_d4": mxu_t["mxu_megakernel"]["full_ms"],
            "rank_ms_bound_ms": (mxu_t["mxu_megakernel"]["full_ms"],
                                 bounds["mxu_megakernel_16"]["bound_ms"],
                                 MAIN_SHAPE),
            "cuda_bvh_ms_same_call": mxu_t["mxu_megakernel"]["cuda_bvh_ms"],
            "cuda_bvh_ms_640x360_spp16_d4": (
                mxu_t["mxu_megakernel"]["cuda_bvh_full_ms"]),
            "profile_640x360_spp16_d4": mxu_prof["mxu_megakernel"],
            "checks": [c for e, c in mxu_checks if e != "bvh_mxu"]
            + main_mxu_checks[2:4],
        },
        {
            "name": "mxu_intersect",
            "route": "cuda",
            **bound_keys("mxu_intersect"),
            "source": "spira_tpu_torch/csrc/mxu_megakernel.cu",
            "replaces": "spira_tpu/kernels/mxu_megakernel.py:284",
            "launches": launches["mxu_intersect"],
            "max_abs_err": mxu_isect_checks[1]["max_abs_err"],
            "ms": mxu_t["mxu_intersect"]["ms"],
            "plain_ms": mxu_t["mxu_intersect"]["plain_ms"],
            "shape": "bunny primary rays 640x360",
            "bound_ms_128_lanes": bounds["mxu_intersect_all_lanes"][
                "bound_ms"],
            "real_lanes": bunny_mxu.lanes.n_lanes,
            "superleaf_runs": superleaf_rows("mxu_intersect"),
            "bvh_intersect_ms_same_rays": isect_k,
            "checks": mxu_isect_checks + main_mxu_checks[4:],
        },
        {
            "name": "bvh_mxu_megakernel",
            "route": "cuda",
            **bound_keys("bvh_mxu_megakernel"),
            "source": "spira_tpu_torch/csrc/bvh_megakernel.cu",
            "leaf_source": "spira_tpu_torch/csrc/superleaf.cuh",
            "replaces": "spira_tpu/kernels/bvh_megakernel.py:252",
            "launches": launches["bvh_mxu_megakernel"],
            "max_abs_err": max(c["max_abs_err"] for e, c in mxu_checks
                               if e == "bvh_mxu"),
            "ms": mxu_t["bvh_mxu_megakernel"]["ms"],
            "bound_ms_128_lanes": bounds["bvh_mxu_megakernel_all_lanes"][
                "bound_ms"],
            "bound_ms_128_lanes_640x360_spp16_d4": bounds[
                "bvh_mxu_megakernel_16_all_lanes"]["bound_ms"],
            "bound_ms_real_lanes": bounds["bvh_mxu_megakernel_real_lanes"][
                "bound_ms"],
            "bound_ms_real_lanes_640x360_spp16_d4": bounds[
                "bvh_mxu_megakernel_16_real_lanes"]["bound_ms"],
            "superleaf_runs": superleaf_rows("bvh_mxu_megakernel_spp4",
                                             "bvh_mxu_megakernel_spp16"),
            "plain_ms": mxu_t["bvh_mxu_megakernel"]["plain_ms"],
            "shape": "bunny 640x360 spp4 d4",
            "ms_640x360_spp16_d4": mxu_t["bvh_mxu_megakernel"]["full_ms"],
            "rank_ms_bound_ms": (mxu_t["bvh_mxu_megakernel"]["full_ms"],
                                 bounds["bvh_mxu_megakernel_16"]["bound_ms"],
                                 MAIN_SHAPE),
            "cuda_bvh_ms_same_call": (
                mxu_t["bvh_mxu_megakernel"]["cuda_bvh_ms"]),
            "cuda_bvh_ms_640x360_spp16_d4": (
                mxu_t["bvh_mxu_megakernel"]["cuda_bvh_full_ms"]),
            "profile_640x360_spp16_d4": mxu_prof["bvh_mxu_megakernel"],
            "counts": mxu_counts,
            "checks": [c for e, c in mxu_checks if e == "bvh_mxu"]
            + main_mxu_checks[:2],
        },
        {
            "name": "vpu_peak",
            "route": "cuda",
            **bound_keys("vpu_peak"),
            "source": "spira_tpu_torch/csrc/peak.cu",
            "replaces": "benchmarks/vpu_peak.py:31",
            "launches": launches["vpu_peak"],
            "max_abs_err": max(c["max_abs_err"] for c in peak_checks),
            "ms": peak_ms["separate"],
            "plain_ms": peak_plain_ms,
            "shape": f"{probe['n_peak']} elements x {vp.CHAINS} chains x "
                     f"{vp.ITERS} iterations, mode separate",
            "ms_by_mode": peak_ms,
            "rates_by_mode": peak_rates,
            "instructions_per_chain_iteration": vp.INSTRUCTIONS,
            "sol_rates": rates.as_dict(),
            "issue_rate": issue_rate,
            "checks": peak_checks,
        },
        {
            "name": "vpu_dtype",
            "route": "cuda",
            **bound_keys("vpu_dtype"),
            "source": "spira_tpu_torch/csrc/peak.cu",
            "replaces": "benchmarks/packet_profile.py:94",
            "launches": launches["vpu_dtype"],
            "max_abs_err": max(c["max_abs_err"] for c in dtype_checks),
            "ms": dtype_ms[("fill", "f32")],
            "plain_ms": dtype_plain_ms,
            "shape": f"{probe['n_dtype']} elements x {pp.CHAIN} steps, f32",
            "bf16_ms": dtype_ms[("fill", "bf16")],
            "gflop_s_fill": {r["dtype"]: r["gflop_s"] for r in dtype_rows
                             if r["grid"] == "fill"},
            "rows": dtype_rows,
            "checks": dtype_checks,
        },
        row_gather_entry,
    ]
    # share of the bound at the timed shape, and the redesign ranking:
    # launches in one call of a main path (the most over the paths counted
    # above) x (time - bound) at the main paths' shape, MAIN (the
    # nearest-hit queries at a MAIN frame's primary rays, the probes at
    # their fill grid), largest first (the script's own counts stay in
    # "launches")
    for k in kernels:
        k["cli_paths"] = cli_paths.get(k["name"], {})
        k["sharded_paths"] = sharded_paths.get(k["name"], {})
        k["examples_paths"] = examples_paths.get(k["name"], {})
        if k["name"] in sbvh:
            k["sbvh"] = {key: v for key, v in sbvh[k["name"]].items()
                         if key != "checks"}
            k["checks"] = k["checks"] + sbvh[k["name"]]["checks"]
        if k["name"] in offset_checks:
            k["checks"] = k["checks"] + [offset_checks[k["name"]]]
        k["share_of_bound_pct"] = sol.sol_pct(k["bound_ms"], k["ms"])
        paths = {path: got[k["name"]] for path, got in main_runs.items()
                 if got.get(k["name"])}
        k["main_path_launches"] = max(paths.values(), default=0)
        k["main_paths"] = paths
        ms, bound, shape = k.pop("rank_ms_bound_ms",
                                 (k["ms"], k["bound_ms"], k["shape"]))
        k["rank_ms"] = k["main_path_launches"] * (ms - bound)
        k["rank_basis_ms"] = dict(ms=ms, bound_ms=bound, shape=shape,
                                  host_ms=k.get("host_ms"))
    for k in sorted(kernels, key=lambda k: -k["rank_ms"]):
        b = k["rank_basis_ms"]
        host = ("" if b["host_ms"] is None else
                f" (of which the host {b['host_ms']:.4f} ms)")
        log(f"[rank] {card}: {k['name']}: {k['main_path_launches']} "
            f"main-path launches x ({b['ms']:.4f}{host} - "
            f"{b['bound_ms']:.4f} ms at {b['shape']}) = {k['rank_ms']:.3f} "
            f"ms; "
            f"{k['share_of_bound_pct']:.3f}% of its "
            f"bound at {k['shape']}, by {k['bound_term']}; counted on "
            f"{k['main_paths'] or 'no main path'}; this script launched it "
            f"{k['launches']} times on its main-path runs")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
