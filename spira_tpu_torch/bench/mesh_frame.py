"""Times of the path-trace frames on the card: the mesh path tracers (#2,
#5), the kernels that share their walk (#3, #2b) and the brute-force path
tracers (#1, #4).

    python3 spira_tpu_torch/bench/mesh_frame.py [--root DIR] [--out PATH]

The frames, each through the wrapper a user calls:

* on the bunny (``create_bunny_scene``'s 72,960-triangle stand-in) at
  640x360, spp 16, depth 4, the shape of a serving frame: #2
  (``render_flat_bvh_megakernel``), #5
  (``render_flat_spectral_bvh_megakernel``), #2b
  (``render_flat_bvh_mxu_megakernel`` on ``attach_superleaf``'s tree) and
  #3 (``intersect_tile`` on the 230,400 primary rays);
* #1 (``render_flat_megakernel``) on the sphere demo and #4
  (``render_flat_spectral_megakernel``) on the spectral Cornell box, at
  640x360 spp 16 depth 4 and at 1920x1080 spp 256 (``BASELINE.json``
  config 5).

For each frame: the wrapper's time with CUDA events (``timing.cuda_ms``: a
warm-up, then the median of 10); ``torch.profiler`` over 5 calls: the time
on the card by kernel name, the device operations of one call by kind
(kernels, copies, memsets), the host's CUDA runtime calls and the grid of
each of the repo's kernels; the host's share of the call (the wrapper's
time less the device's); a SHA-256 digest of the output's bytes.  For #1
and #4 also the kernel's resident blocks an SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (a probe library built
from the checkout's own source, which it includes) and the waves its grid
takes.  Then a digest of each image of ``chip_smoke.py``'s cases of #1
(a-c) and #4 (g-i), of the bunny's wavefront frame (``render_flat``
at 640x360, spp 16, depth 4, RGB and spectral) and of #7's frame of the
1,600-triangle mesh scene at that shape, and ``ptxas -v`` of the
libraries, so that two commits' images can be held equal to the bit.

``--root`` imports ``spira_tpu_torch`` from another checkout (a ``git
archive`` of another commit unpacked into a directory ``.gitignore``
lists), so that one call on one card times two commits' kernels with the
same script; the calls it makes have the same signatures at every commit
since the superleaf engines were ported.  Prints one JSON line (and
appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPE = dict(width=640, height=360, spp=16, max_depth=4)
BIG = dict(width=1920, height=1080, spp=256, max_depth=4)
#: the libraries the timed kernels live in
LIBRARIES = ("bvh_megakernel", "spectral_megakernel", "megakernel")
#: the brute-force kernels whose occupancy is asked: library -> kernel
OCCUPANCY = dict(megakernel="spira::megakernel",
                 spectral_megakernel="spira::spectral_megakernel")
THREADS = 128
#: chip_smoke.py's cases of #1 (a-c) and #4 (g-i): (name, spectral, scene,
#: camera, aspect, shape), seed 7
CASES = (
    ("a", False, "create_scene", "default_camera", None,
     dict(width=640, height=360, spp=1, max_depth=1)),
    ("b", False, "create_scene", "default_camera", None, SHAPE),
    ("c", False, "create_cornell_box", "cornell_camera", None,
     dict(width=256, height=256, spp=16, max_depth=6)),
    ("g", True, "create_scene", "default_camera", None,
     dict(width=640, height=360, spp=1, max_depth=1)),
    ("h", True, "create_cornell_box", "cornell_camera", 1.0,
     dict(width=256, height=256, spp=16, max_depth=6)),
    ("i", True, "create_cornell_box", "cornell_camera", None, SHAPE),
)


def primary_rays(cam, width, height):
    """Pinhole rays through the pixel centres, bottom-up rows: (N, 3)
    origins and unit directions."""
    dev = cam.origin.device
    v = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5) / height
    u = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5) / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = (cam.lower_left_corner + uu.reshape(-1, 1) * cam.horizontal
         + vv.reshape(-1, 1) * cam.vertical - cam.origin)
    d = d / d.norm(dim=1, keepdim=True)
    return cam.origin.expand_as(d).contiguous(), d.contiguous()


def digest(*tensors):
    """SHA-256 (16 hex digits) of the tensors' bytes, on the host."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _kernel_name(name):
    # "void spira::foo<1>(...)" -> "spira::foo"
    return re.split(r"[<(]", name.replace("(anonymous namespace)::", "")
                    .removeprefix("void "))[0]


def profile_call(fn, runs=5):
    """``torch.profiler`` over ``runs`` calls of ``fn`` after a warm-up:
    ms and launches a call on the card by kernel name, ms a call on the
    card in all and on the host's clock (the calls and a final
    synchronisation), the device operations a call by kind, the host's
    CUDA runtime calls a call, and the grid of each of the repo's kernels
    from the trace."""
    from torch.profiler import ProfilerActivity

    from spira_tpu_torch.bench import timing

    fn()
    torch.cuda.synchronize()
    with timing.profile_window([ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    by_name, launches, ops, runtime = {}, {}, {}, {}
    for e in timing.device_events(prof):
        name = _kernel_name(e.name)
        by_name[name] = (by_name.get(name, 0.0)
                         + e.time_range.elapsed_us() / runs / 1e3)
        launches[name] = launches.get(name, 0) + 1 / runs
        kind = ("memcpy" if name.startswith("Memcpy") else "memset"
                if name.startswith("Memset") else "kernel")
        ops[kind] = ops.get(kind, 0) + 1 / runs
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                and e.name.startswith("cuda")):
            runtime[e.name] = runtime.get(e.name, 0) + 1 / runs
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    grids = {_kernel_name(ev["name"]): ev.get("args", {}).get("grid")
             for ev in trace.get("traceEvents", [])
             if ev.get("cat") == "kernel" and "spira" in ev.get("name", "")}
    return dict(
        kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        launches=launches,
        device_ms=sum(by_name.values()),
        wall_ms=wall_ms,
        device_ops={k: round(v, 3) for k, v in sorted(ops.items())},
        runtime_calls={k: round(v, 3) for k, v in sorted(runtime.items())},
        grids=grids)


def occupancy():
    """Resident blocks an SM of each kernel of OCCUPANCY at THREADS
    threads, as a function of its dynamic shared memory: a probe library
    per source (nvcc, the root's own flags) that includes the source and
    asks cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from spira_tpu_torch import _build

    def build(item):
        lib, kernel = item
        src = _build.CSRC / f"{lib}.cu"
        h = hashlib.sha256(kernel.encode()
                           + " ".join(_build.NVCC_FLAGS).encode())
        for path in sorted(_build.CSRC.glob("*.cu*")):
            h.update(path.read_bytes())
        out = _build.BUILD_DIR / f"occupancy_{lib}-{h.hexdigest()[:16]}.so"
        if not out.is_file():
            _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            probe = out.with_suffix(".cu")
            probe.write_text(
                f'#include "{src}"\n'
                'extern "C" int spira_probe_occupancy(int threads, '
                'long long smem, int* blocks) {\n'
                '  return static_cast<int>('
                'cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
                f'      blocks, {kernel}, threads, '
                'static_cast<size_t>(smem)));\n}\n')
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                   str(tmp), str(probe)],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed building {probe.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        fn = ctypes.CDLL(str(out)).spira_probe_occupancy
        fn.argtypes = (ctypes.c_int, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_int))

        def per_sm(smem):
            n = ctypes.c_int(0)
            err = fn(THREADS, smem, ctypes.byref(n))
            if err:
                raise RuntimeError(f"occupancy query of {kernel}: CUDA "
                                   f"error {err}")
            return n.value

        return per_sm

    with ThreadPoolExecutor(len(OCCUPANCY)) as pool:
        return dict(zip(OCCUPANCY, pool.map(build, OCCUPANCY.items())))


def measure(device, probes):
    """The times above, for the ``spira_tpu_torch`` on ``sys.path``."""
    import spira_tpu_torch as sp
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import megakernel as mk
    from spira_tpu_torch.kernels import spectral_bvh as sb
    from spira_tpu_torch.kernels import spectral_fused as sf

    w, h = SHAPE["width"], SHAPE["height"]
    bunny, _ = sp.create_bunny_scene(allow_download=False, device=device)
    bunny_sl = sp.attach_superleaf(bunny)
    cam = sp.bunny_camera(w / h, device=device)
    rays = primary_rays(cam, w, h)
    demo = sp.create_scene(device=device)
    cornell = sp.create_cornell_box(device=device)
    # the shared memory #1 and #4 stage, bytes
    demo_smem = 4 * (20 + 16 * demo.spheres.count + 24 * demo.triangles.count)
    cornell_smem = 4 * (20 + 36 + 33 * cornell.spheres.count
                        + 41 * cornell.triangles.count)
    # name: (call, its library and dynamic shared memory for the occupancy
    # query, or None)
    calls = dict(
        bvh_megakernel=(lambda: bk.render_flat_bvh_megakernel(
            bunny, cam, **SHAPE), None),
        spectral_bvh_megakernel=(lambda: (
            sb.render_flat_spectral_bvh_megakernel(bunny, cam, **SHAPE)),
            None),
        bvh_mxu_megakernel=(lambda: bk.render_flat_bvh_mxu_megakernel(
            bunny_sl, cam, **SHAPE), None),
        bvh_intersect=(lambda: bk.intersect_tile(bunny.packed, *rays,
                                                 with_slot=True), None),
    )
    for shape, suffix in ((SHAPE, ""), (BIG, "_1920x1080_spp256")):
        demo_cam = sp.default_camera(shape["width"] / shape["height"],
                                     device=device)
        cornell_cam = sp.cornell_camera(shape["width"] / shape["height"],
                                        device=device)
        calls["megakernel" + suffix] = (
            lambda c=demo_cam, s=shape: mk.render_flat_megakernel(
                demo, c, **s), ("megakernel", demo_smem))
        calls["spectral_megakernel" + suffix] = (
            lambda c=cornell_cam, s=shape: (
                sf.render_flat_spectral_megakernel(cornell, c, **s)),
            ("spectral_megakernel", cornell_smem))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    frames = {}
    for name, (call, occ) in calls.items():
        out = call()
        ms = cuda_ms(call)
        prof = profile_call(call)
        row = dict(wrapper_ms=ms, **prof, host_ms=ms - prof["device_ms"],
                   host_share=(ms - prof["device_ms"]) / ms,
                   digest=digest(*(out if isinstance(out, tuple)
                                   else (out,))))
        if occ is not None:
            lib, smem = occ
            grid = prof["grids"].get(OCCUPANCY[lib])
            blocks = grid[0] * grid[1] * grid[2] if grid else None
            per_sm = probes[lib](smem)
            row.update(blocks_per_sm=per_sm, smem_bytes=smem,
                       grid_blocks=blocks,
                       waves=blocks / (per_sm * sms) if blocks else None)
        frames[name] = row
    cases = {}
    for case, spectral, scene_fn, cam_fn, aspect, shape in CASES:
        fn = (sf.render_flat_spectral_megakernel if spectral
              else mk.render_flat_megakernel)
        scene = getattr(sp, scene_fn)(device=device)
        c = getattr(sp, cam_fn)(aspect or shape["width"] / shape["height"],
                                device=device)
        cases[case] = digest(fn(scene, c, seed=7, **shape))
    # the wavefront frame of the bunny (render_flat, #3 a bounce)
    for spectral in (False, True):
        cases["render_flat" + "_spectral" * spectral] = digest(
            sp.render_flat(bunny, cam, spectral=spectral, **SHAPE))
    # #7 on the 1,600-triangle mesh scene
    from spira_tpu_torch.kernels import mxu_megakernel as xk

    mesh = sp.attach_mxu(sp.attach_packed(sp.create_mesh_scene(
        device=device)))
    cases["mxu_megakernel"] = digest(xk.render_flat_mxu_megakernel(
        mesh, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                             aspect_ratio=w / h, device=device), **SHAPE))
    return dict(frames=frames, case_digests=cases, sms=sms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="the checkout whose spira_tpu_torch to time "
                    "(default: this one)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import timing

    device = timing.require_cuda("mesh_frame")
    with ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        probes = pool.submit(occupancy)
        libs = dict(zip(LIBRARIES, pool.map(_build.load, LIBRARIES)))
        probes = probes.result()
    times = measure(device, probes)
    # ptxas -v of the libraries (built by this process unless the checkout
    # had them cached)
    ptxas = {name: [line.strip() for line in lib.log.splitlines()
                    if "registers" in line or "spill" in line
                    or "entry function" in line]
             for name, lib in libs.items()}
    h = hashlib.sha256()
    for path in sorted((root / "spira_tpu_torch" / "csrc").glob("*.cu*")):
        h.update(path.read_bytes())
    timing.record(args.out, script="mesh_frame", card=timing.card_line(),
                  root=str(root), csrc_sha256=h.hexdigest()[:16],
                  shapes=dict(main=SHAPE, big=BIG), ptxas=ptxas, **times)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
