"""Streaming superleaf path tracer and nearest-hit query (mesh scenes,
physical semantics, RGB): the plain PyTorch versions and the wrappers of
the two CUDA kernels.

Counterpart of :mod:`spira_tpu.kernels.mxu_megakernel`: every ray tests
every superleaf block of an :class:`~spira_tpu_torch.accel.mxu.MXUBVH`
(``accel/mxu.py``), with no tree.  The JAX package contracts a block
against a (8, 128) ray tile on the TPU's matrix unit, all 128 lanes,
because the unit has that width.  The plain version runs the same lane
test over all rays at once (:func:`.bvh_megakernel.lane_hits`) on the
coefficient tables as packed.

* :func:`render_flat_mxu_megakernel` — the CUDA path tracer
  (``csrc/mxu_megakernel.cu``, ``spira_mxu_megakernel_render``, replacing
  ``spira_tpu/kernels/mxu_megakernel.py:205 _kernel``, #7) for scenes on
  a CUDA device; for scenes on the CPU, :func:`render_flat_mxu_fused`.
* :func:`intersect_tile_mxu` — the CUDA nearest-hit query
  (``spira_mxu_intersect``, replacing ``:284 _raw_intersect_kernel``,
  #8) for rays on a CUDA device; on the CPU, :func:`intersect_mxu_plain`.
* The plain version: :func:`stream_blocks`, the block loop, and
  :func:`make_mxu_stream_intersect`, the ``intersect_fn`` it gives
  :func:`.megakernel.trace_tile` (spheres first: their nearest hit seeds
  ``best_t``).

What bounds the kernels is the lane test itself: 50 float instructions
and an IEEE division a lane and ray (``utils/sol.py``).  So they read
each lane as one lane-major record of six float4s (the tree's ``lanes``,
:class:`~spira_tpu_torch.accel.mxu.LaneRecords`, derived once per tree)
and test only a block's real lanes: a padding lane is all zero and never
hits.  #8, whose threads all stream every block, holds several rays a
thread and stages the blocks in shared memory through a ring of bulk
copies, so one record load feeds several tests.  #7's paths reach the
intersect at different bounces, so it stages the scene's records in
shared memory once, before its paths start, where they fit
(:func:`choose_route`: ``"staged"``), and reads them through the
read-only path where they do not (``"global"``, the bunny); the wrapper
counts each route.  On the staged route a thread traces several samples
with path regeneration, so that a warp's lanes are not held idle by its
longest path.  The lane test sums the terms of the packed tables'
columns in the plain version's order, so both kernels equal their plain
versions to the bit.

Ties: a block's winner is its lowest lane among equal ``t``, and a later
block replaces the best hit only with a strictly smaller ``t``, as in
``spira_tpu/kernels/mxu_megakernel.py:137-154``.  The JAX kernel pads the
block count to a multiple of ``CHUNK`` and the ray count to whole
(8, 128) tiles; those are its tiling, not outputs, and the port takes any
block count, ray count and image size.
"""

from __future__ import annotations

import ctypes
import functools
import logging

import torch

from .. import _build
from ..accel.mxu import SUPERLEAF, MXUBVH, SuperleafBVH
from . import bvh_megakernel as bk
from . import megakernel as mk

_log = logging.getLogger(__name__)


def _require_tables(scene):
    """The superleaf blocks the streaming engine reads: ``scene.wide``."""
    if not isinstance(scene.wide, (MXUBVH, SuperleafBVH)):
        raise ValueError(
            "scene has no MXU superleaf tables; call "
            "spira_tpu_torch.accel.mxu.attach_mxu"
        )
    return scene.wide


def n_blocks(tables) -> int:
    """Superleaf blocks in the coefficient tables."""
    return tables.coeff_uv.shape[0] // 8


def stream_blocks(tables, o, d, best, active=None):
    """Nearest triangle hit of each ray over every block of ``tables``, in
    block order, beating ``best``: returns (t, normal (N, 3), mat id as
    float (-1: none), slot = block * 128 + lane (-1: none)).  o, d: (N, 3);
    best: (N,); ``active``: optional (N,) bool, rays left out keep
    ``best``."""
    n = o.shape[0]
    t = best.clone()
    nrm = torch.zeros_like(o)
    mid = torch.full_like(best, -1.0)
    slot = torch.full((n,), -1, dtype=torch.long, device=o.device)
    idx = (torch.arange(n, device=o.device) if active is None
           else active.nonzero()[:, 0])
    if idx.numel() == 0:
        return t, nrm, mid, slot
    o_l, d_l = o[idx], d[idx]
    bt, bn, bm, bs = t[idx], nrm[idx], mid[idx], slot[idx]
    uv, tc, pay = bk.block_views(tables)
    for b in range(uv.shape[0]):
        won, tb, lane = bk.lane_hits(uv[b], tc[b], o_l, d_l, bt)
        rows = pay[b, 0:4][:, lane]  # (4, L)
        bt = torch.where(won, tb, bt)
        bn = torch.where(won[:, None], rows[0:3].T, bn)
        bm = torch.where(won, rows[3], bm)
        bs = torch.where(won, b * SUPERLEAF + lane, bs)
    t[idx], nrm[idx], mid[idx], slot[idx] = bt, bn, bm, bs
    return t, nrm, mid, slot


def make_mxu_stream_intersect(spheres, tables, mat_table):
    """The ``intersect_fn`` for :func:`.megakernel.trace_tile` over the
    superleaf blocks: the sphere loop seeds ``best_t``, the block stream
    beats it (:func:`.bvh_megakernel.make_walk_intersect`)."""
    return bk.make_walk_intersect(
        spheres, functools.partial(stream_blocks, tables), mat_table)


def render_flat_mxu_fused(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Plain-PyTorch streaming render → flat (H*W, 3) bottom-up HDR
    buffer, on the scene's device.  Same math, block order and RNG as the
    CUDA kernel."""
    tables = _require_tables(scene)
    intersect = make_mxu_stream_intersect(
        bk.sphere_tuples(scene), tables, bk.pack_materials(scene.materials))
    return bk.trace_mesh(scene, camera, intersect, width=width,
                         height=height, spp=spp, max_depth=max_depth,
                         seed=seed, inclusive_uv=inclusive_uv)


def intersect_mxu_plain(tables, origins, dirs):
    """Plain-PyTorch nearest hit of (N, 3) rays over every superleaf block:
    (t (N,), normal (N, 3), mat id (N,) int32), with t = 1e20, normal 0
    and mat id -1 on a miss."""
    best = torch.full((origins.shape[0],), mk.INF, dtype=torch.float32,
                      device=origins.device)
    t, nrm, mid, _ = stream_blocks(tables, origins, dirs, best)
    return t, nrm, mid.to(torch.int32)


# ----------------------------------------------------------------------------
# The CUDA kernels
# ----------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
_LL_P = ctypes.POINTER(ctypes.c_longlong)
#: records, offsets, n_lanes, n_blocks, coeff_pay, staged
_RENDER_ARGTYPES = (_VP, _VP, _I, _I, _VP, _I)
_INTERSECT_ARGTYPES = (
    _VP, _VP, _I,  # origins, dirs, n
    _VP, _VP, _I, _I, _VP,  # records, offsets, n_blocks, max_lanes, coeff_pay
    _VP, _VP, _VP,  # t, normal, mid
    _VP,  # stream
)
#: #7's routes: the records staged in shared memory, or read through the
#: read-only path where they do not fit
ROUTES = ("staged", "global")


def _lane_args(tables, device):
    """The checked tables and their lane records (``tables.lanes``, derived
    on the device at first use) as kernels #7 and #8 read them."""
    blocks = n_blocks(tables)
    return bk.check_lane_records(tables, device, blocks), blocks


def choose_route(scene, lanes, blocks, spp):
    """#7's route for ``scene`` at ``spp`` on its card: ``"staged"`` where
    the records, the offsets, the camera, sphere and material tables and
    the sample values fit the shared memory a block may take
    (``spira_mxu_render_smem``), else ``"global"``, whose block holds the
    tables and values only; raises where neither fits (an spp in the
    tens of thousands: render it in parts)."""
    index = scene.device.index
    return _route(torch.cuda.current_device() if index is None else index,
                  scene.spheres.count, scene.materials.count, lanes.n_lanes,
                  blocks, spp)


@functools.lru_cache(maxsize=256)
def _route(device_index, n_spheres, n_mats, n_lanes, blocks, spp):
    fn = _build.entry("mxu_megakernel", "spira_mxu_render_smem",
                      (_I, _I, _I, _I, _I, _I, _LL_P, _LL_P))
    for route in ROUTES:
        need, budget = ctypes.c_longlong(), ctypes.c_longlong()
        with torch.cuda.device(device_index):
            err = fn(n_spheres, n_mats, n_lanes, blocks, spp,
                     int(route == "staged"), ctypes.byref(need),
                     ctypes.byref(budget))
        mk._launch_error("spira_mxu_render_smem", err)
        if need.value <= budget.value:
            return route
    raise ValueError(f"spp {spp} needs {need.value} bytes of shared memory "
                     f"for the sample values, over the {budget.value} a "
                     "block may take; render fewer samples a call")


def render_flat_mxu_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Streaming superleaf render → flat (H*W, 3) bottom-up HDR buffer.

    Requires superleaf tables on ``scene.wide``
    (:func:`spira_tpu_torch.accel.mxu.attach_mxu`).  A scene on a CUDA
    device launches ``csrc/mxu_megakernel.cu`` (built on first use) on the
    route :func:`choose_route` picks, logs the route at debug level, and
    adds one to ``render_flat_mxu_megakernel.launches`` and to
    ``render_flat_mxu_megakernel.routes[route]``; a scene on the CPU runs
    :func:`render_flat_mxu_fused`.  Same PCG stream as the other path
    tracers, so a scene renders as on the packed-BVH kernel up to the
    intersector's last bits.  Any other device, and any input the kernel
    does not take, raises.
    """
    tables = _require_tables(scene)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv)
    if scene.device.type == "cpu":
        return render_flat_mxu_fused(scene, camera, **kw)
    return _launch_render(scene, camera, tables, None, **kw)


def _launch_render(scene, camera, tables, route, **kw):
    """Launch #7 on ``route`` (None: :func:`choose_route`'s) and count it."""
    lanes, blocks = _lane_args(tables, scene.device)
    route = route or choose_route(scene, lanes, blocks, kw["spp"])
    _log.debug("mxu_megakernel: %s route, %d lanes in %d blocks", route,
               lanes.n_lanes, blocks)
    out = bk.launch_render(
        "mxu_megakernel", "mxu_megakernel", "spira_mxu_megakernel_render",
        _RENDER_ARGTYPES,
        (lanes.records.data_ptr(), lanes.offsets.data_ptr(), lanes.n_lanes,
         blocks, tables.coeff_pay.data_ptr(), int(route == "staged")),
        scene, camera, **kw)
    render_flat_mxu_megakernel.launches += 1
    render_flat_mxu_megakernel.routes[route] += 1
    return out


#: Kernel launches since the count was last reset (set it to 0 to reset),
#: and the launches by route (reset with ``routes.update(dict.fromkeys(
#: ROUTES, 0))``).
render_flat_mxu_megakernel.launches = 0
render_flat_mxu_megakernel.routes = dict.fromkeys(ROUTES, 0)


def intersect_tile_mxu(tables, origins, dirs):
    """Nearest hit of (N, 3) rays over every superleaf block of ``tables``
    (an MXUBVH or SuperleafBVH): (t (N,), normal (N, 3), mat id (N,)
    int32), with t = 1e20, normal 0 and mat id -1 on a miss.

    Rays on a CUDA device launch the CUDA kernel and add one to
    ``intersect_tile_mxu.launches``; rays on the CPU run
    :func:`intersect_mxu_plain`.
    """
    device = origins.device
    if device.type == "cpu":
        return intersect_mxu_plain(tables, origins, dirs)
    if device.type != "cuda":
        raise ValueError(f"intersect_tile_mxu runs on cuda or cpu, not "
                         f"{device}")
    n = origins.shape[0]
    for name, t in (("origins", origins), ("dirs", dirs)):
        mk._check_table(name, t, device, 3)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rays, origins {n}")
    lanes, blocks = _lane_args(tables, device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=device)
    mid = torch.empty(n, dtype=torch.int32, device=device)
    fn = _build.entry("mxu_megakernel", "spira_mxu_intersect",
                      _INTERSECT_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(origins.data_ptr(), dirs.data_ptr(), n,
                 lanes.records.data_ptr(), lanes.offsets.data_ptr(), blocks,
                 lanes.max_lanes, tables.coeff_pay.data_ptr(), t.data_ptr(),
                 nrm.data_ptr(), mid.data_ptr(), stream)
    mk._launch_error("mxu_intersect", err)
    intersect_tile_mxu.launches += 1
    return t, nrm, mid


#: Kernel launches since the count was last reset (set it to 0 to reset).
intersect_tile_mxu.launches = 0
