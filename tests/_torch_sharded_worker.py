"""One rank of the multi-process tests in ``tests/test_torch_sharded.py``.

    python tests/_torch_sharded_worker.py JOB RANK WORLD DIR

Joins a gloo world of WORLD ranks through a ``FileStore`` in DIR (a
collective waits at most ``TIMEOUT``), reads the inputs the test wrote to
``DIR/inputs.pt``, runs JOB on the CPU and writes what it measured to
``DIR/out<RANK>.pt``.  It imports neither JAX nor the JAX package: they
are blocked before anything is imported.  An exception exits non-zero,
which fails the test.
"""

import datetime
import os
import sys

sys.modules["jax"] = None  # the port must not need them
sys.modules["spira_tpu"] = None

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from spira_tpu_torch import pipeline  # noqa: E402
from spira_tpu_torch.diff import inverse  # noqa: E402
from spira_tpu_torch.kernels.megakernel import true_divide  # noqa: E402
from spira_tpu_torch.parallel import (  # noqa: E402
    accumulate_row_set_sharded,
    gather_image,
    host_row_ranges,
    make_mesh,
    render_chunk_sharded,
    render_flat_sharded,
    replicate,
)
from spira_tpu_torch.parallel.distributed import gather_rows  # noqa: E402
from spira_tpu_torch.utils import config  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)


def world4(inp, rank, out_dir):
    """The 4-rank world: mesh layouts, frames, chunks, the row-set
    dispatch, the adaptive renderer, the gradient and one inverse step."""
    out = {}
    frame = inp["frame"]
    meshes = {shape: make_mesh(*shape, device="cpu")
              for shape in ((2, 2), (4, 1), (1, 4), (2, 1))}
    out["ranks"] = {shape: m.ranks for shape, m in meshes.items()}
    out["coords"] = {shape: m.coords if rank < m.size else None
                     for shape, m in meshes.items()}
    try:
        make_mesh(4, 2, device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    m22, m41 = meshes[(2, 2)], meshes[(4, 1)]
    out["row_ranges"] = host_row_ranges(frame["height"], m22)

    demo, demo_cam = (replicate(x, m22) for x in inp["demo"])
    for shape in ((2, 2), (4, 1)):
        for engine in ("fused", "wavefront"):
            tile = render_flat_sharded(demo, demo_cam, mesh=meshes[shape],
                                       engine=engine, **frame)
            out["frame", shape, engine] = gather_image(tile, meshes[shape])
    # the chunks of a sharded render, summed, against its one-shot frame
    kw = dict(width=frame["width"], height=frame["height"],
              max_depth=frame["max_depth"], seed=frame["seed"], mesh=m22)
    half = frame["spp"] // 2
    chunks = [render_chunk_sharded(demo, demo_cam, k * half, n_samples=half,
                                   **kw) for k in range(2)]
    out["chunks"] = gather_image(
        true_divide(chunks[0] + chunks[1], float(frame["spp"])), m22)

    # the mesh scene on the packed engines: #2's plain version over a 4x1
    # split, and the packed hook's wavefront against the plain walk's
    mesh_scene, mesh_cam = inp["mesh"]
    for engine in ("cuda_bvh", "bvh_sorted", "wavefront"):
        tile = render_flat_sharded(mesh_scene, mesh_cam, mesh=m41,
                                   engine=engine, **frame)
        out["mesh_frame", engine] = gather_image(tile, m41)

    # one adaptive round's dispatch on a fixed padded row set, and the
    # sharded adaptive renderer
    rs = inp["row_set"]
    sums = accumulate_row_set_sharded(
        demo, demo_cam, rs["key"], torch.tensor(rs["rows"]),
        rs["sample_base"], width=frame["width"], height=frame["height"],
        n_samples=rs["n_samples"], max_depth=frame["max_depth"], mesh=m22)
    out["row_set"] = gather_rows(
        torch.cat([sums[0], sums[1][:, None], sums[2][:, None]], 1),
        m22).numpy()
    ad = inp["adaptive"]
    ascene, acam = (replicate(x, m22) for x in inp["adaptive_scene"])
    out["adaptive"] = pipeline.render_adaptive(
        ascene, acam, config.RenderConfig(**ad["cfg"]), mesh=m22,
        return_stats=True, **ad["kw"])

    # render_for_grad's loss and gradients, on (2, 2) against JAX and on
    # (1, 4) against the unsharded render
    g = inp["grad"]
    gscene, gcam = inp["grad_scene"]
    target = torch.from_numpy(g["target"])
    for shape in ((2, 2), (1, 4)):
        params = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in g["start"].items()}
        tile = inverse.render_for_grad(params, gscene, gcam, mesh=meshes[shape],
                                       seed=g["seed"], **g["kw"])
        loss, grads = inverse.sharded_mse_grads(
            tile, target, list(params.values()), meshes[shape])
        out["grad", shape] = (float(loss),
                              {k: v.numpy() for k, v in zip(params, grads)})
    # one sharded inverse step: the parameters after it, on every rank
    step, init = inverse.make_inverse_step(mesh=m22, learning_rate=2e-2,
                                           **g["kw"])
    params = {k: torch.from_numpy(v.copy()) for k, v in g["start"].items()}
    opt = init(params)
    params, opt, loss = step(params, opt, gscene, gcam, target, 0)
    out["step"] = (float(loss),
                   {k: v.detach().numpy() for k, v in params.items()})
    return out


def world2(inp, rank, out_dir):
    """The 2-rank world: ``run_config(n_tile=2)``, each rank given its own
    output path, and the same sharded render gathered."""
    cfg = dict(inp["cfg"], output=os.path.join(out_dir, f"rank{rank}.png"))
    img = pipeline.run_config(config.RenderConfig(**cfg))
    mesh = make_mesh(2, 1, device="cpu")
    scene, cam = (replicate(x, mesh) for x in
                  config.build_scene(config.RenderConfig(**cfg)))
    tile = render_flat_sharded(
        scene, cam, width=cfg["width"], height=cfg["height"], mesh=mesh,
        spp=cfg["spp"], max_depth=cfg["max_depth"], seed=cfg["seed"])
    return dict(img=img, flat=gather_image(tile, mesh))


JOBS = dict(world4=world4, world2=world2)


def main() -> int:
    job, rank, n, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        out = JOBS[job](inp, rank, out_dir)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
