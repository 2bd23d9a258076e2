"""The port's sharded rendering (``spira_tpu_torch.parallel``) against the
JAX package's, on the CPU at small sizes.

JAX's side runs in this process on the 8-device virtual CPU mesh that
``tests/conftest.py`` sets up.  The port's side runs either as shard
bodies in this process or in a gloo world of 4 (or 2) ranks, each a
process of ``tests/_torch_sharded_worker.py`` that imports no JAX, joined
through a ``FileStore`` in ``tmp_path`` (no TCP port: the tests run in
several workers at once), each collective bounded by the worker's
timeout, the world by ``WORLD_TIMEOUT``; a rank that fails ends the world
and fails the test.

Tolerances, stated beside each test:

* ``fused`` and the mesh kernels' plain versions key PCG on the global
  pixel and sample, so a split of the rows only is the unsharded frame to
  the bit (spp 4, a power of two);
* estimates held against JAX's are held as ``tests/test_torch_pipeline.
  py`` holds them (at least 99% of rows within rtol 1e-4 / atol 1e-5,
  channel means within 1e-4 relative; ``FUSED``: JAX's XLA tracer against
  the port's plain one, as ``tests/test_torch_megakernel.py`` holds it):
  the draws are JAX's bits, but a last-bit difference may flip a branch;
* a split of the samples adds the same samples in another order: within
  ``SUM_ORDER`` (a few float32 ulps of the largest radiance).
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spira_tpu as st
from spira_tpu.core import rng as jr
from spira_tpu.diff import inverse as jinv
from spira_tpu.kernels.megakernel import fused_rows as j_fused_rows
from spira_tpu.parallel import distributed as jdist
from spira_tpu.parallel.mesh import make_mesh as j_make_mesh
from spira_tpu.parallel.sharded import (
    accumulate_row_set_sharded as j_row_set_sharded,
)
from spira_tpu.parallel.sharded import render_flat_sharded as j_sharded
from spira_tpu import pipeline as jpipe
from spira_tpu.utils import config as jconfig
import spira_tpu_torch as sp
from spira_tpu_torch import pipeline
from spira_tpu_torch.core import rng as srng
from spira_tpu_torch.diff import inverse
from spira_tpu_torch.kernels import bvh_megakernel as bk
from spira_tpu_torch.kernels import megakernel as mk
from spira_tpu_torch.io import image as img_io
from spira_tpu_torch.parallel import (
    Mesh,
    distributed,
    make_mesh,
    render_flat_sharded,
    render_hdr_sharded,
)
from spira_tpu_torch.parallel.sharded import sample_slot, tile_rows
from spira_tpu_torch.utils import config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_sharded_worker.py")
#: the longest a world may take, its imports included
WORLD_TIMEOUT = 240.0
W, H = 32, 16
FRAME = dict(width=W, height=H, spp=4, max_depth=2, seed=3)
FRAME_RENDER = {k: v for k, v in FRAME.items() if k not in ("width",
                                                          "height")}
RTOL, ATOL, FRAC, MEAN_REL = 1e-4, 1e-5, 0.99, 1e-4
FUSED = dict(atol=1e-4, frac=0.99)
SUM_ORDER = 4e-6
#: render_for_grad: the demo at 16x8 spp 4 depth 3 (spp 4 splits over
#: the (1, 4) mesh)
GKW = dict(width=16, height=8, spp=4, max_depth=3)
ROW_SET = dict(rows=[0, 3, 5, 9, 10, 11, 15, 2], sample_base=4, n_samples=2,
               seed=3)
ADAPTIVE = dict(cfg=dict(width=128, height=8, spp=8, max_depth=3,
                         progress=False, output="", device="cpu"),
                kw=dict(tol=0.1, min_spp=2, chunk=2))


def _port(jscene, jcam):
    as_np = jax.tree_util.tree_map(np.asarray, (jscene, jcam))
    return (sp.scene_from_numpy(as_np[0], device="cpu"),
            sp.camera_from_numpy(as_np[1], device="cpu"))


def _close(got, want):
    """Estimates: the share of rows within RTOL / ATOL, and the means."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    near = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    frac = (near.all(-1) if got.ndim > 1 else near).mean()
    assert frac >= FRAC, frac
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _grad_inputs():
    jscene, jcam = st.create_scene(), st.default_camera(GKW["width"]
                                                        / GKW["height"])
    scene, cam = _port(jscene, jcam)
    target = np.random.default_rng(1).uniform(
        0.0, 1.0, (GKW["width"] * GKW["height"], 3)).astype(np.float32)
    albedo = scene.materials.albedo.numpy().copy()
    albedo[:2] = ((0.2, 0.7, 0.7), (0.9, 0.2, 0.9))
    start = {"albedo": albedo,
             "emission": scene.materials.emission.numpy() * 0.5 + 0.25}
    return jscene, jcam, (scene, cam), dict(target=target, start=start,
                                            seed=5, kw=GKW)


def spawn(job, world, tmp_path, inputs):
    """Run ``job`` of the worker in a gloo world of ``world`` processes;
    returns each rank's output.  A rank that exits non-zero ends the
    world (the others are killed) and fails the test, with every rank's
    log; so does a world past ``WORLD_TIMEOUT``."""
    torch.save(inputs, tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"log{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), str(tmp_path)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                        f"{f.read()[-3000:]}")
            f.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("a rank failed or the world timed out:\n"
                    + "\n".join(text))
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def demo():
    jscene, jcam = st.create_scene(), st.default_camera(W / H)
    return jscene, jcam, _port(jscene, jcam)


@pytest.fixture(scope="module")
def mesh_scene():
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                         aspect_ratio=W / H, device="cpu")
    return scene, cam


@pytest.fixture(scope="module")
def world4(demo, mesh_scene, tmp_path_factory):
    """One 4-rank world, run once for the tests below that read it."""
    jscene, jcam, port = demo
    ajscene, ajcam = jconfig.build_scene(_jax_cfg(ADAPTIVE["cfg"]))
    _, _, gport, grad = _grad_inputs()
    inputs = dict(
        frame=FRAME, demo=port, mesh=mesh_scene,
        row_set=dict(ROW_SET, key=srng.base_key(ROW_SET["seed"])),
        adaptive=ADAPTIVE, adaptive_scene=_port(ajscene, ajcam),
        grad=grad, grad_scene=gport)
    return spawn("world4", 4, tmp_path_factory.mktemp("world4"), inputs)


def _jax_cfg(cfg):
    cfg = dict(cfg)
    cfg.pop("device")
    return jconfig.RenderConfig(**cfg)


# ---------------------------------------------------------------------------
# The mesh and the process group
# ---------------------------------------------------------------------------

def test_mesh_layout_matches_jax(world4):
    """Rank ``t * n_spp + s`` holds position (t, s): JAX's
    ``devices[:n].reshape(n_tile, n_spp)`` with a rank for each device;
    ranks past the mesh hold none; a mesh larger than the world raises
    JAX's ``ValueError``."""
    for rank, out in enumerate(world4):
        for shape, ranks in out["ranks"].items():
            ids = np.vectorize(lambda d: d.id)(j_make_mesh(*shape).devices)
            np.testing.assert_array_equal(ranks, ids)
            want = divmod(rank, shape[1]) if rank < ranks.size else None
            assert out["coords"][shape] == want
        assert "needs 8 ranks, have 4" in out["too_big"]
    with pytest.raises(ValueError, match="needs 16"):
        j_make_mesh(16, 1)


def test_host_row_ranges_and_gather(world4):
    """The rows of each rank at s == 0, bottom-up, cover the frame in
    order; every rank gathers the same whole frame."""
    out = world4[0]
    assert out["row_ranges"] == {0: [(0, H // 2)], 2: [(H // 2, H)]}
    for key in [k for k in out if k[0] == "frame"]:
        assert out[key].shape == (W * H, 3)
        for other in world4[1:]:
            np.testing.assert_array_equal(other[key], out[key])


def test_initialize_single_process_noop(monkeypatch):
    """Without a world in the environment ``initialize`` sets nothing up,
    and the process is the primary; a mesh of one rank needs no group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.shape == {"tile": 1, "spp": 1} and mesh.coords == (0, 0)
    flat = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(distributed.gather_image(flat, mesh),
                                  flat.numpy())
    assert distributed.host_row_ranges(16, mesh) == {0: [(0, 16)]}
    jdist.initialize()
    assert jdist.is_primary()


def test_render_hdr_sharded_on_one_rank(demo):
    """A mesh of one rank needs no process group: ``render_hdr_sharded``
    on ``fused`` is the plain tracer's assembled image to the bit."""
    _, _, (scene, cam) = demo
    got = render_hdr_sharded(scene, cam, W, H, make_mesh(device="cpu"),
                             engine="fused", **FRAME_RENDER)
    want = img_io.assemble_image(mk.render_flat_fused(scene, cam, **FRAME),
                                 W, H)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The shard bodies
# ---------------------------------------------------------------------------

def test_fused_rows_matches_jax_at_offsets(demo):
    """``fused_rows`` over rows 5-7 at samples 3-4 against JAX's (within
    ``FUSED``), and the plain tracer's frame split over two tiles equal to
    the unsharded frame to the bit."""
    jscene, jcam, (scene, cam) = demo
    kw = dict(width=W, n_rows=3, row_start=5, sample_offset=3, spp=2,
              max_depth=2, seed=1, du=float(W - 1), dv=float(H - 1))
    got = mk.fused_rows(scene, cam, **kw).numpy()
    want = np.asarray(j_fused_rows(jscene, jcam, **kw))
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= FUSED["atol"]).mean() >= FUSED["frac"]
    kw.update(n_rows=H // 2, sample_offset=0, spp=4)
    tiles = [mk.fused_rows(scene, cam, **dict(kw, row_start=t * H // 2))
             for t in range(2)]
    full = mk.render_flat_fused(scene, cam, width=W, height=H, spp=4,
                                max_depth=2, seed=1)
    assert torch.equal(mk.true_divide(torch.cat(tiles), 4.0), full)


def test_bvh_rows_plain_split_equals_the_frame(mesh_scene):
    """``bvh_rows``' plain version over a 4x1 split is the unsharded plain
    frame to the bit; over a split of the samples within ``SUM_ORDER``."""
    scene, cam = mesh_scene
    kw = dict(width=W, height=H, max_depth=2, seed=3)
    full = bk.render_flat_bvh_fused(scene, cam, spp=4, **kw)
    tiles = [bk.bvh_rows(scene, cam, n_rows=4, row_start=4 * t,
                         sample_offset=0, spp=4, **kw) for t in range(4)]
    assert torch.equal(mk.true_divide(torch.cat(tiles), 4.0), full)
    halves = [bk.bvh_rows(scene, cam, n_rows=H, row_start=0,
                          sample_offset=2 * k, spp=2, **kw)
              for k in range(2)]
    got = mk.true_divide(halves[0] + halves[1], 4.0)
    assert float((got - full).abs().max()) <= SUM_ORDER * float(full.max())
    with pytest.raises(ValueError, match="outside a frame"):
        bk.bvh_rows(scene, cam, n_rows=4, row_start=14, sample_offset=0,
                    spp=1, **kw)


# ---------------------------------------------------------------------------
# The sharded frame, chunks and engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("engine", ["fused", "wavefront"])
def test_render_flat_sharded_matches_jax(world4, demo, shape, engine):
    """The gathered sharded frame against JAX's on the same mesh: the
    wavefront within the estimate tolerances (its tiles fold their row
    into the keys, as JAX's do), ``fused`` within ``FUSED``; at (4, 1)
    ``fused`` is the port's unsharded plain frame to the bit."""
    jscene, jcam, (scene, cam) = demo
    got = world4[0]["frame", shape, engine]
    want = np.asarray(j_sharded(jscene, jcam, mesh=j_make_mesh(*shape),
                                engine=engine, **FRAME))
    if engine == "wavefront":
        _close(got, want)
        return
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=MEAN_REL)
    assert (np.abs(got - want) <= FUSED["atol"]).mean() >= FUSED["frac"]
    full = mk.render_flat_fused(scene, cam, **FRAME).numpy()
    if shape == (4, 1):
        np.testing.assert_array_equal(got, full)
    else:
        assert np.abs(got - full).max() <= SUM_ORDER * full.max()


def test_chunks_sum_to_the_sharded_frame(world4):
    """Two sharded chunks of 2 samples, summed, against the one-shot
    sharded frame at (2, 2): the same samples, added in another order."""
    got, want = world4[0]["chunks"], world4[0]["frame", (2, 2), "wavefront"]
    assert np.abs(got - want).max() <= SUM_ORDER * want.max()


def test_sharded_mesh_engines(world4, mesh_scene):
    """On the mesh scene at (4, 1): ``cuda_bvh``'s plain version is the
    unsharded plain frame to the bit; ``bvh_sorted`` (the packed query's
    hook) against the wavefront's plain stackless walk within the
    estimate tolerances (the same draws, another intersector: ties)."""
    scene, cam = mesh_scene
    out = world4[0]
    np.testing.assert_array_equal(
        out["mesh_frame", "cuda_bvh"],
        bk.render_flat_bvh_fused(scene, cam, **FRAME).numpy())
    _close(out["mesh_frame", "bvh_sorted"], out["mesh_frame", "wavefront"])


def test_sharded_refusals(demo):
    """JAX's ``ValueError``s for a height or spp that does not divide by
    its axis, and the engines' own: JAX's names, reference semantics off
    the wavefront, spectral transport on an RGB kernel."""
    _, _, (scene, cam) = demo
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by tile axis 3"):
        tile_rows(Mesh(n_tile=3, n_spp=1, rank=0, device=cpu), H)
    with pytest.raises(ValueError, match="spp 4 not divisible by spp axis"):
        sample_slot(Mesh(n_tile=1, n_spp=3, rank=0, device=cpu), 4)
    mesh = make_mesh(1, 1, device="cpu")
    for engine, kw in (("pallas_bvh", {}),
                       ("fused", dict(semantics="reference")),
                       ("cuda_bvh", dict(spectral=True))):
        with pytest.raises(ValueError):
            render_flat_sharded(scene, cam, mesh=mesh, engine=engine,
                                **FRAME, **kw)


# ---------------------------------------------------------------------------
# The adaptive renderer
# ---------------------------------------------------------------------------

def test_row_set_sharded_matches_jax(world4, demo):
    """One round's dispatch on a padded set of 8 rows at (2, 2): tile t
    draws from ``fold_in(key, t)`` over its contiguous half of the set,
    the samples split over the spp axis, against JAX's
    ``accumulate_row_set_sharded`` within the estimate tolerances."""
    jscene, jcam, _ = demo
    a, l, l2 = j_row_set_sharded(
        jscene, jcam, jr.base_key(ROW_SET["seed"]),
        jnp.asarray(ROW_SET["rows"]), ROW_SET["sample_base"], width=W,
        height=H, n_samples=ROW_SET["n_samples"],
        max_depth=FRAME["max_depth"], mesh=j_make_mesh(2, 2))
    got = world4[0]["row_set"]
    _close(got[:, :3], np.asarray(a))
    _close(got[:, 3], np.asarray(l))
    _close(got[:, 4], np.asarray(l2))
    for other in world4[1:]:
        np.testing.assert_array_equal(other["row_set"], got)


def test_adaptive_sharded_schedule_matches_jax(world4):
    """The sharded adaptive renderer at (2, 2) against JAX's on the same
    config and hyperparameters (128x8, cap 8, chunk 2, rows, tol 0.1), as
    ``tests/test_torch_pipeline.py`` holds the unsharded one: at least 80%
    of the rows retire at the same spp, the spp maps' means within 10%,
    the image means within 2%, the RMSE below a quarter of the mean; every
    rank's ledger the same."""
    jscene, jcam = jconfig.build_scene(_jax_cfg(ADAPTIVE["cfg"]))
    jimg, jstats = jpipe.render_adaptive(
        jscene, jcam, _jax_cfg(ADAPTIVE["cfg"]), mesh=j_make_mesh(2, 2),
        return_stats=True, **ADAPTIVE["kw"])
    img, stats = world4[0]["adaptive"]
    assert len(np.unique(jstats["spp_map"])) >= 2
    assert (stats["spp_map"] == jstats["spp_map"]).mean() >= 0.8
    np.testing.assert_allclose(stats["spp_map"].mean(),
                               jstats["spp_map"].mean(), rtol=0.1)
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=0.02)
    assert np.sqrt(np.mean((img - jimg) ** 2)) < 0.25 * jimg.mean()
    assert stats["dispatched_samples"] >= stats["total_samples"]
    for other in world4[1:]:
        np.testing.assert_array_equal(other["adaptive"][0], img)
        np.testing.assert_array_equal(other["adaptive"][1]["spp_map"],
                                      stats["spp_map"])


# ---------------------------------------------------------------------------
# The gradient and the inverse step
# ---------------------------------------------------------------------------

def test_sharded_grads_match_jax_and_the_unsharded_step(world4):
    """``render_for_grad(mesh=)``'s global MSE and its gradients, summed
    over every rank: at (2, 2) against JAX's ``jax.grad`` through its
    sharded render (loss within 1e-5 relative, gradients within 1e-4
    relative L2, ``tests/test_torch_inverse.py``'s bounds); at (1, 4),
    whose keys are the unsharded render's, against the port's unsharded
    loss and gradients within float-sum order (1e-5 relative)."""
    jscene, jcam, (scene, cam), g = _grad_inputs()
    target = jnp.asarray(g["target"])

    def jloss(params):
        img = jinv.render_for_grad(params, jscene, jcam, seed=g["seed"],
                                   mesh=j_make_mesh(2, 2), **GKW)
        return jinv.mse_loss(img, target)

    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in g["start"].items()})
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in g["start"].items()}
    loss = inverse.mse_loss(inverse.render_for_grad(
        params, scene, cam, seed=g["seed"], **GKW),
        torch.from_numpy(g["target"]))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    loss = float(loss.detach())
    for out in world4:
        got_loss, got_g = out["grad", (2, 2)]
        np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
        for k, v in got_g.items():
            assert np.abs(v).max() > 0, k
            assert _rel_l2(v, np.asarray(want_g[k])) <= 1e-4, k
        got_loss, got_g = out["grad", (1, 4)]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        for k, v in got_g.items():
            assert _rel_l2(v, grads[k].numpy()) <= 1e-5, k


def test_inverse_step_keeps_ranks_identical(world4):
    """One ``make_inverse_step(mesh=)`` step at (2, 2): every rank's
    parameters identical to the bit afterwards, moved from the start, and
    within 1e-5 of JAX's sharded step's (its loss within 1e-5
    relative)."""
    jscene, jcam, _, g = _grad_inputs()
    jstep, jinit = jinv.make_inverse_step(mesh=j_make_mesh(2, 2),
                                          learning_rate=2e-2, **GKW)
    jparams = {k: jnp.asarray(v) for k, v in g["start"].items()}
    jparams, _, jl = jstep(jparams, jinit(jparams), jscene, jcam,
                           jnp.asarray(g["target"]), 0)
    loss, params = world4[0]["step"]
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    for k, v in params.items():
        assert not np.array_equal(v, g["start"][k]), k
        np.testing.assert_allclose(v, np.asarray(jparams[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
        for other in world4[1:]:
            np.testing.assert_array_equal(other["step"][1][k], v)


# ---------------------------------------------------------------------------
# run_config over two ranks
# ---------------------------------------------------------------------------

def test_run_config_n_tile_two_ranks(tmp_path):
    """``run_config(n_tile=2)`` in a 2-rank world: both ranks return the
    same image, the tone-mapped gather of the sharded wavefront frame;
    only rank 0 writes its PNG; the image against JAX's ``run_config``
    with ``n_tile=2`` on its CPU mesh, its uint8 levels within 1 on 99% of
    the pixels."""
    from PIL import Image

    cfg = dict(width=W, height=H, spp=4, max_depth=2, seed=2, n_tile=2,
               progress=False, device="cpu")
    outs = spawn("world2", 2, tmp_path, dict(cfg=cfg))
    np.testing.assert_array_equal(outs[0]["img"], outs[1]["img"])
    hdr = img_io.assemble_image(torch.from_numpy(outs[0]["flat"]), W, H)
    want = pipeline._tonemap(config.RenderConfig(**cfg), hdr)
    np.testing.assert_array_equal(outs[0]["img"], want)
    assert os.path.exists(tmp_path / "rank0.png")
    assert not os.path.exists(tmp_path / "rank1.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path
                                                        / "rank0.png")),
                                  want)
    jimg = jpipe.run_config(_jax_cfg(dict(cfg, output="")))
    close = np.abs(outs[0]["img"].astype(int) - jimg.astype(int)) <= 1
    assert close.all(-1).mean() >= 0.99
