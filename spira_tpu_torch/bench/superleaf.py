"""Times of the superleaf kernels on the card: the streaming path tracer
(#7), its nearest-hit query (#8) and the packed-BVH path tracer with
superleaf leaves (#2b).

    python3 spira_tpu_torch/bench/superleaf.py [--root DIR] [--variants]
        [--out PATH]

The calls, each through the wrapper a user calls, at 640x360, depth 4:

* #7 (``render_flat_mxu_megakernel``) on the 1,600-triangle mesh scene
  (``create_mesh_scene``, ``attach_mxu``) at spp 4 and 16;
* #8 (``intersect_tile_mxu``) on the bunny's 230,400 primary rays
  (``create_bunny_scene``'s 72,960-triangle stand-in, ``attach_mxu``);
* #2b (``render_flat_bvh_mxu_megakernel``) on the bunny
  (``attach_superleaf``) at spp 4 and 16.

For each: the time of one call on the card (``timing.cuda_ms``: a
warm-up, then the median of 10 calls each between two CUDA events) and a
SHA-256 digest of the output's bytes, so that two commits' outputs can be
held equal to the bit.  Where the checkout's #7 has routes
(``mxu_megakernel.ROUTES``), #7 on the mesh also runs on each route, whose
frames must equal the chosen route's to the bit, and the routes chosen
for the mesh and the bunny are reported.  Then ``ptxas -v`` of the
library (empty when it was already built).

``--variants`` (this checkout's sources only) also builds a library that
includes ``csrc/mxu_megakernel.cu`` with other launch shapes of the same
kernels (``INTERSECT_VARIANTS``: threads a block, rays a thread, ring
stages; ``RENDER_VARIANTS``: threads a block, route and samples a
thread); it times each on
the same inputs, holds its output to the shipped kernel's bits, and
reports its ``ptxas -v`` registers and spills and, from ``cuobjdump
-sass``, the instructions of the lane loop (the loop around ``MUFU.RCP``)
per lane and ray, by opcode.

``--root`` imports ``spira_tpu_torch`` from another checkout (a ``git
archive`` of another commit unpacked into a directory ``.gitignore``
lists), so that one call on one card times two commits' kernels; every
commit since the superleaf engines were ported takes these calls.  Prints
one JSON line (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPE = dict(width=640, height=360, max_depth=4)
SPPS = (4, 16)
#: #8's launch shapes tried by --variants: (threads a block, rays a
#: thread, ring stages)
INTERSECT_VARIANTS = ((64, 2, 2), (64, 4, 2), (128, 1, 2), (128, 2, 2),
                      (128, 2, 3), (128, 4, 2), (256, 2, 2), (256, 4, 2))
#: #7's launch shapes tried by --variants: (threads a block, staged,
#: samples a thread at least, traced with path regeneration; 1 at spp 16 is
#: one sample a thread, no regeneration)
RENDER_VARIANTS = ((1024, 1, 1), (1024, 1, 2), (1024, 1, 4), (768, 1, 4),
                   (768, 1, 8), (640, 1, 8), (512, 1, 8), (128, 0, 1),
                   (128, 0, 4))


def digest(*tensors):
    """SHA-256 (16 hex digits) of the tensors' bytes, on the host."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def primary_rays(cam, width, height):
    """Pinhole rays through the pixel centres, bottom-up rows: (N, 3)
    origins and unit directions (``bench/mesh_frame.py``'s)."""
    dev = cam.origin.device
    v = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5) / height
    u = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5) / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = (cam.lower_left_corner + uu.reshape(-1, 1) * cam.horizontal
         + vv.reshape(-1, 1) * cam.vertical - cam.origin)
    d = d / d.norm(dim=1, keepdim=True)
    return cam.origin.expand_as(d).contiguous(), d.contiguous()


def scenes(device):
    """The mesh on ``attach_mxu``, the bunny on both superleaf packings,
    their cameras at SHAPE's aspect, and the bunny's primary rays."""
    import spira_tpu_torch as sp

    w, h = SHAPE["width"], SHAPE["height"]
    mesh = sp.attach_mxu(sp.attach_packed(sp.create_mesh_scene(
        device=device)))
    bunny, _ = sp.create_bunny_scene(allow_download=False, device=device)
    cam = sp.bunny_camera(w / h, device=device)
    return dict(
        mesh=mesh, mesh_cam=sp.make_camera(
            (0.0, 1.0, 3.0), (0.0, 0.0, 0.0), aspect_ratio=w / h,
            device=device),
        bunny=bunny, bunny_mxu=sp.attach_mxu(bunny),
        bunny_sl=sp.attach_superleaf(bunny), bunny_cam=cam,
        rays=primary_rays(cam, w, h))


def calls(s):
    """name: the call, for each timed kernel."""
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import mxu_megakernel as xk

    out = {}
    for spp in SPPS:
        out[f"mxu_megakernel_spp{spp}"] = (
            lambda spp=spp: xk.render_flat_mxu_megakernel(
                s["mesh"], s["mesh_cam"], spp=spp, **SHAPE))
    out["mxu_intersect"] = lambda: xk.intersect_tile_mxu(s["bunny_mxu"].wide,
                                                         *s["rays"])
    for spp in SPPS:
        out[f"bvh_mxu_megakernel_spp{spp}"] = (
            lambda spp=spp: bk.render_flat_bvh_mxu_megakernel(
                s["bunny_sl"], s["bunny_cam"], spp=spp, **SHAPE))
    return out


def time_calls(fns):
    """{name: {ms, digest}} over ``fns``."""
    from spira_tpu_torch.bench.timing import cuda_ms

    rows = {}
    for name, fn in fns.items():
        out = fn()
        rows[name] = dict(ms=cuda_ms(fn), digest=digest(
            *(out if isinstance(out, tuple) else (out,))))
    return rows


def routes(s, frames):
    """#7 on each route on the mesh (the frames must equal the wrapper's
    frame to the bit) and the route the wrapper picks for the mesh and
    the bunny; None where the checkout's #7 has no routes."""
    from spira_tpu_torch.kernels import mxu_megakernel as xk

    if not hasattr(xk, "ROUTES"):
        return None
    fns = {f"{route}_spp{spp}": (
        lambda route=route, spp=spp: xk._launch_render(
            s["mesh"], s["mesh_cam"], s["mesh"].wide, route, spp=spp,
            seed=0, inclusive_uv=True, **SHAPE))
        for route in xk.ROUTES for spp in SPPS}
    rows = time_calls(fns)
    for name, row in rows.items():
        want = frames[f"mxu_megakernel_spp{name.split('spp')[1]}"]["digest"]
        if row["digest"] != want:
            raise AssertionError(f"#7 on the {name} route differs from "
                                 "the wrapper's frame")
    chosen = {}
    for key in ("mesh", "bunny_mxu"):
        wide = s[key].wide
        lanes = wide.lanes
        chosen[key] = dict(route=xk.choose_route(s[key], lanes,
                                                 xk.n_blocks(wide),
                                                 max(SPPS)),
                           lanes=lanes.n_lanes, blocks=xk.n_blocks(wide),
                           max_lanes=lanes.max_lanes,
                           record_bytes=4 * lanes.records.numel())
    return dict(mesh=rows, chosen=chosen)


# ---------------------------------------------------------------------------
# --variants: other launch shapes of the same kernels
# ---------------------------------------------------------------------------

def _variant_source():
    """The source of the variant library."""
    from spira_tpu_torch import _build

    csrc = _build.CSRC
    isect = "\n".join(
        f"    case {k}: return launch_intersect<{t}, {r}, {st}>(origins, "
        "dirs, n, records, offsets, n_blocks, max_lanes, coeff_pay, t, "
        "normal, mid, static_cast<cudaStream_t>(stream));"
        for k, (t, r, st) in enumerate(INTERSECT_VARIANTS))
    render = "\n".join(
        f"    case {k}: return launch_render<{t}, {'true' if st else 'false'}"
        ">(cam, spheres, n_spheres, mats, n_mats, records, offsets, "
        "n_lanes, n_blocks, coeff_pay, out, width, height, spp, max_depth, "
        "seed, du, dv, inv_spp, has_lens, static_cast<cudaStream_t>(stream), "
        f"{r});" for k, (t, st, r) in enumerate(RENDER_VARIANTS))
    budget = "\n".join(
        f"    case {k}: return smem_budget<{t}, {'true' if st else 'false'}>("
        f"n_spheres, n_mats, n_lanes, n_blocks, spp, need, budget, {r});"
        for k, (t, st, r) in enumerate(RENDER_VARIANTS))
    mxu = f'''#include "{csrc}/mxu_megakernel.cu"
using namespace spira;
extern "C" int spira_variant_intersect(
    int v, const float* origins, const float* dirs, int n,
    const float* records, const int* offsets, int n_blocks, int max_lanes,
    const float* coeff_pay, float* t, float* normal, int* mid, void* stream) {{
  switch (v) {{
{isect}
  }}
  return -1;
}}
extern "C" int spira_variant_render(
    int v, const float* cam, const float* spheres, int n_spheres,
    const float* mats, int n_mats, const float* records, const int* offsets,
    int n_lanes, int n_blocks, const float* coeff_pay, float* out, int width,
    int height, int spp, int max_depth, uint32_t seed, float du, float dv,
    float inv_spp, int has_lens, void* stream) {{
  switch (v) {{
{render}
  }}
  return -1;
}}
extern "C" int spira_variant_budget(int v, int n_spheres, int n_mats,
                                    int n_lanes, int n_blocks, int spp,
                                    long long* need, long long* budget) {{
  switch (v) {{
{budget}
  }}
  return -1;
}}
'''
    return mxu


def _build_variant(name, source):
    """nvcc the variant library (the package's flags): (CDLL, ptxas log,
    path)."""
    from spira_tpu_torch import _build

    h = hashlib.sha256(source.encode() + " ".join(_build.NVCC_FLAGS).encode())
    for path in sorted(_build.CSRC.glob("*.cu*")):
        h.update(path.read_bytes())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    src = out.with_suffix(".cu")
    src.write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed building {src.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr, out


def ptxas_lines(log):
    """The ``ptxas -v`` lines that name a kernel, its registers or its
    spills."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
            or "entry function" in line]


def lane_loop_sass(path):
    """For each kernel of the library at ``path`` whose SASS has a loop
    around ``MUFU.RCP``: the instructions of the innermost such loop
    (from a backward branch's target to the branch), its reciprocals, and
    the instructions per reciprocal, i.e. per lane and ray (the slow path
    of the IEEE division, out of line, is not counted), with the loop's
    instructions by opcode."""
    from spira_tpu_torch import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        rcp = [a for a, text in ins if "MUFU.RCP" in text]
        if not rcp:
            continue
        best = None
        for addr, text in ins:
            m = re.search(r"BRA(?:\.\S+)?\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)",
                          text)
            if not m:
                continue
            target = int(m.group(1), 16)
            inside = [a for a in rcp if target <= a < addr]
            if target < addr and inside and (
                    best is None or addr - target < best[1] - best[0]):
                best = (target, addr, len(inside))
        if best is None:
            continue
        body = [text for a, text in ins if best[0] <= a <= best[1]]
        ops = {}
        for text in body:
            op = text.split()[1 if text.startswith("@") else 0]
            ops[op] = ops.get(op, 0) + 1
        out[name] = dict(instructions=len(body), reciprocals=best[2],
                         per_lane_and_ray=len(body) / best[2],
                         opcodes=dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])))
    return out


def variants(s):
    """Each variant of INTERSECT_VARIANTS and RENDER_VARIANTS, timed on the
    same inputs as the shipped kernels and held to their bits."""
    from spira_tpu_torch.bench.timing import cuda_ms
    from spira_tpu_torch.kernels import bvh_megakernel as bk
    from spira_tpu_torch.kernels import megakernel as mk
    from spira_tpu_torch.kernels import mxu_megakernel as xk

    lib, log, path = _build_variant("variants_mxu", _variant_source())
    vp, vi, vf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rows = dict(ptxas=ptxas_lines(log), sass=lane_loop_sass(path))
    stream = torch.cuda.current_stream().cuda_stream

    # #8
    fn = lib.spira_variant_intersect
    fn.argtypes = (vi, vp, vp, vi, vp, vp, vi, vi, vp, vp, vp, vp, vp)
    tables = s["bunny_mxu"].wide
    lanes = tables.lanes
    o, d = s["rays"]
    n = o.shape[0]
    want = digest(*xk.intersect_tile_mxu(tables, o, d))
    rows["mxu_intersect"] = {}
    for k, shape in enumerate(INTERSECT_VARIANTS):
        t = torch.empty(n, device=o.device)
        nrm = torch.empty((n, 3), device=o.device)
        mid = torch.empty(n, dtype=torch.int32, device=o.device)

        def call(k=k, t=t, nrm=nrm, mid=mid):
            err = fn(k, o.data_ptr(), d.data_ptr(), n,
                     lanes.records.data_ptr(), lanes.offsets.data_ptr(),
                     xk.n_blocks(tables), lanes.max_lanes,
                     tables.coeff_pay.data_ptr(), t.data_ptr(),
                     nrm.data_ptr(), mid.data_ptr(), stream)
            mk._launch_error(f"variant {shape}", err)
        ms = cuda_ms(call)
        rows["mxu_intersect"][str(shape)] = dict(
            ms=ms, same_bits=digest(t, nrm, mid) == want)

    # #7: the camera, sphere and material tables as the wrapper packs them
    def tables_of(scene, cam, spp):
        cam_t = mk.pack_camera(cam).contiguous()
        sph = mk.pack_scene(scene).contiguous()
        mat = bk.pack_materials(scene.materials).contiguous()
        du, dv = mk._uv_scale(SHAPE["width"], SHAPE["height"], True)
        head = (cam_t.data_ptr(), sph.data_ptr(), sph.shape[0],
                mat.data_ptr(), mat.shape[0])
        tail = (SHAPE["width"], SHAPE["height"], spp, SHAPE["max_depth"], 0,
                du, dv, mk._inv_spp(spp), int(cam.has_lens), stream)
        return head, tail, (cam_t, sph, mat)

    head_t = (vp, vp, vi, vp, vi)
    tail_t = (vi, vi, vi, vi, ctypes.c_uint32, vf, vf, vf, vi, vp)
    fn = lib.spira_variant_render
    fn.argtypes = (vi, *head_t, vp, vp, vi, vi, vp, vp, *tail_t)
    budget_fn = lib.spira_variant_budget
    ll = ctypes.POINTER(ctypes.c_longlong)
    budget_fn.argtypes = (vi, vi, vi, vi, vi, vi, ll, ll)
    mesh, cam = s["mesh"], s["mesh_cam"]
    lanes = mesh.wide.lanes
    blocks = xk.n_blocks(mesh.wide)
    rows["mxu_megakernel"] = {}
    for spp in SPPS:
        want = digest(xk.render_flat_mxu_megakernel(mesh, cam, spp=spp,
                                                    **SHAPE))
        head, tail, keep = tables_of(mesh, cam, spp)
        for k, shape in enumerate(RENDER_VARIANTS):
            need, have = ctypes.c_longlong(), ctypes.c_longlong()
            mk._launch_error("variant budget", budget_fn(
                k, mesh.spheres.count, mesh.materials.count, lanes.n_lanes,
                blocks, spp, ctypes.byref(need), ctypes.byref(have)))
            if need.value > have.value:
                continue
            out = torch.empty((SHAPE["width"] * SHAPE["height"], 3),
                              device=o.device)

            def call(k=k, out=out, head=head, tail=tail):
                err = fn(k, *head, lanes.records.data_ptr(),
                         lanes.offsets.data_ptr(), lanes.n_lanes, blocks,
                         mesh.wide.coeff_pay.data_ptr(), out.data_ptr(),
                         *tail)
                mk._launch_error(f"variant {shape}", err)
            ms = cuda_ms(call)
            rows["mxu_megakernel"][f"{shape} spp{spp}"] = dict(
                ms=ms, same_bits=digest(out) == want)
        del keep
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="the checkout whose spira_tpu_torch to time "
                    "(default: this one)")
    ap.add_argument("--variants", action="store_true",
                    help="also time other launch shapes of this "
                    "checkout's kernels")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from spira_tpu_torch import _build
    from spira_tpu_torch.bench import timing

    device = timing.require_cuda("superleaf")
    with ThreadPoolExecutor(2) as pool:
        libs = dict(zip(("mxu_megakernel", "bvh_megakernel"), pool.map(
            _build.load, ("mxu_megakernel", "bvh_megakernel"))))
    s = scenes(device)
    frames = time_calls(calls(s))
    row = dict(frames=frames, routes=routes(s, frames))
    if args.variants:
        row["variants"] = variants(s)
    h = hashlib.sha256()
    for path in sorted((root / "spira_tpu_torch" / "csrc").glob("*.cu*")):
        h.update(path.read_bytes())
    timing.record(args.out, script="superleaf", card=timing.card_line(),
                  root=str(root), pid=os.getpid(),
                  csrc_sha256=h.hexdigest()[:16], shape=SHAPE,
                  ptxas={k: ptxas_lines(v.log) for k, v in libs.items()},
                  **row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
