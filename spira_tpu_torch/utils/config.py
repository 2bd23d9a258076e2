"""Render configuration: a dataclass and its command-line flags.

Counterpart of :mod:`spira_tpu.utils.config`, with the same fields,
defaults, JSON form and presets, plus one field, ``device``: the port's
constructors build on the card and raise where there is none, so the
configuration says where to run (``"cuda"`` by default, ``"cpu"`` on a
host without a card).  Nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple

from ..render import ENGINES


@dataclasses.dataclass
class RenderConfig:
    # scene
    scene: str = "default"  # default | cornell | mesh | bunny | <path.obj>
    # camera
    lookfrom: Tuple[float, float, float] = (0.0, 1.0, 3.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vfov: float = 60.0
    aperture: float = 0.0
    focus_dist: Optional[float] = None
    # film
    width: int = 640
    height: int = 360
    spp: int = 32
    max_depth: int = 4
    # estimator
    semantics: str = "physical"  # physical | reference
    spectral: bool = False
    engine: str = "auto"  # one of ENGINE_CHOICES
    shading: str = "full"  # full | preview | normal (single-bounce looks)
    seed: int = 0
    tonemap: str = "gamma"  # gamma | aces | none
    # execution
    n_tile: Optional[int] = None  # None = single device
    n_spp_axis: int = 1
    # adaptive sampling: segments stop once their relative luminance
    # half-CI95 falls below this (None = uniform spp everywhere)
    adaptive_tol: Optional[float] = None
    adaptive_min_spp: int = 8
    # retirement unit: "block" (128-px segments, block-mean CI) or "row"
    # (whole rows, quantile CI)
    adaptive_granularity: str = "block"
    # io
    output: str = "render.png"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # samples between checkpoints; 0 = off
    progress: bool = True
    # where the scene is built and rendered: "cuda" | "cpu"
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        d = json.loads(text)
        for k in ("lookfrom", "lookat"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        return cls(**d)


def same_render(config_json: str, cfg: RenderConfig) -> bool:
    """Whether a checkpoint's config JSON asks for the image ``cfg`` asks
    for: every field equal but ``device``, which says where the samples
    run, not which samples they are (a JSON without it, as the JAX
    package writes, matches any device)."""
    saved = json.loads(config_json)
    want = json.loads(cfg.to_json())
    saved.pop("device", None)
    want.pop("device", None)
    return saved == want


#: every engine the configuration and the command line accept: the
#: renderer's (``render.ENGINES``) and ``auto``, which
#: ``render.select_engine`` resolves
ENGINE_CHOICES = ("auto",) + ENGINES

#: engines whose mesh scenes need the pair tables at build time
_PACKED_ENGINES = ("auto", "cuda_bvh", "cuda_spectral_bvh", "bvh_sorted")


#: quality tiers: ``quick`` the reference's smoke-test size, ``demo`` its
#: package main, ``quality`` its GPU tier
PRESETS = {
    "quick": dict(width=320, height=180, spp=4, max_depth=2),
    "demo": dict(width=640, height=360, spp=32, max_depth=4),
    "quality": dict(width=1280, height=720, spp=100, max_depth=10),
}


def add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="default",
                   help="default | cornell | mesh | bunny | path/to/model.obj")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="quality tier setting width/height/spp/max-depth "
                        "(explicit flags still override)")
    # None sentinels so config_from_args can tell a typed flag (which wins
    # over a preset in any spelling) from a default
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--semantics", default="physical",
                   choices=["physical", "reference"])
    p.add_argument("--spectral", action="store_true")
    p.add_argument("--shading", default="full",
                   choices=["full", "preview", "normal"],
                   help="full path tracing, or single-bounce quick looks")
    p.add_argument("--engine", default="auto", choices=list(ENGINE_CHOICES),
                   help="execution engine (auto picks per scene and device;"
                        " the cuda_*mxu engines are retired experiments — "
                        "see spira_tpu_torch.experiments)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tonemap", default="gamma",
                   choices=["gamma", "aces", "none"])
    p.add_argument("--lookfrom", type=float, nargs=3, default=[0.0, 1.0, 3.0])
    p.add_argument("--lookat", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--vfov", type=float, default=60.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focus-dist", type=float, default=None)
    p.add_argument("--n-tile", type=int, default=None,
                   help="tile-axis rank count: render over a (n-tile, "
                        "n-spp-axis) mesh of the torch.distributed ranks "
                        "(run under torchrun; --engine is ignored)")
    p.add_argument("--n-spp-axis", type=int, default=1,
                   help="spp-axis rank count under --n-tile")
    p.add_argument("--adaptive-tol", type=float, default=None,
                   help="adaptive sampling: stop segments whose relative "
                        "luminance CI95 falls below this (--spp = cap)")
    p.add_argument("--adaptive-min-spp", type=int, default=8)
    p.add_argument("--adaptive-granularity", default="block",
                   choices=["block", "row"],
                   help="adaptive retirement unit: 128-px blocks "
                        "(block-mean CI) or whole rows (quantile CI)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--no-progress", dest="progress", action="store_false")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to build and render (cuda raises on a host "
                        "without a card; nothing falls back to the CPU)")


def config_from_args(args: argparse.Namespace) -> RenderConfig:
    # the film fields the user left unset take the preset's values if
    # --preset, else the demo's
    film = dict(PRESETS["demo"])
    if getattr(args, "preset", None):
        film.update(PRESETS[args.preset])
    for field, value in film.items():
        if getattr(args, field, None) is None:
            setattr(args, field, value)
    return RenderConfig(
        scene=args.scene,
        lookfrom=tuple(args.lookfrom),
        lookat=tuple(args.lookat),
        vfov=args.vfov,
        aperture=args.aperture,
        focus_dist=args.focus_dist,
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_depth=args.max_depth,
        semantics=args.semantics,
        spectral=args.spectral,
        engine=args.engine,
        shading=args.shading,
        seed=args.seed,
        tonemap=args.tonemap,
        n_tile=args.n_tile,
        n_spp_axis=args.n_spp_axis,
        adaptive_tol=args.adaptive_tol,
        adaptive_min_spp=args.adaptive_min_spp,
        adaptive_granularity=args.adaptive_granularity,
        output=args.output,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        progress=args.progress,
        device=args.device,
    )


def build_scene(cfg: RenderConfig):
    """Resolve ``cfg.scene`` to (Scene, Camera) on ``cfg.device``.

    ``bunny`` is the procedural 72,960-triangle stand-in: the port never
    fetches the real OBJ (pass its path as the scene instead).  A mesh
    scene gets its pair tables here when an engine that feeds on them may
    render it, under the JAX package's conditions; the progressive
    renderer's scenes skip them.
    """
    from ..core.device import resolve_device
    from ..scene.camera import make_camera
    from ..scene.scene import (
        cornell_camera,
        create_cornell_box,
        create_mesh_scene,
        create_scene,
    )

    device = resolve_device(cfg.device)
    aspect = cfg.width / cfg.height
    if cfg.scene == "default":
        scene = create_scene(device=device)
    elif cfg.scene == "cornell":
        return (create_cornell_box(device=device),
                cornell_camera(aspect, device=device))
    elif cfg.scene == "mesh":
        scene = create_mesh_scene(device=device)
    elif cfg.scene == "bunny":
        from ..scene.bunny import bunny_camera, create_bunny_scene

        scene, _ = create_bunny_scene(allow_download=False, device=device)
        return scene, bunny_camera(aspect, device=device)
    elif cfg.scene.endswith(".obj"):
        scene = create_mesh_scene(obj_path=cfg.scene, device=device)
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    wants_packed = (
        cfg.engine in _PACKED_ENGINES
        and cfg.n_tile is None
        and not cfg.checkpoint_dir
        and cfg.checkpoint_every <= 0
        and cfg.semantics == "physical"
    )
    if wants_packed and scene.bvh is not None and scene.packed is None:
        from ..accel.pairs import attach_packed

        scene = attach_packed(scene)
    camera = make_camera(
        lookfrom=cfg.lookfrom,
        lookat=cfg.lookat,
        vfov=cfg.vfov,
        aspect_ratio=aspect,
        aperture=cfg.aperture,
        focus_dist=cfg.focus_dist,
        device=device,
    )
    return scene, camera
