"""``frames``: a user rendering final frames.  Each call is
``spira_tpu_torch.render()`` at the mix's size, samples, depth, tone map
and engine (and any further ``render_kwargs``), returning the (H, W, 3)
uint8 image on the host; the run keeps, of every frame, the pixels it
will check.  Judged by ``px_off`` against the reference's uint8 values
of those pixels (:func:`pbref.judge.frame_pixels`)."""

from __future__ import annotations

import functools
import importlib

import numpy as np
import torch
from torch.profiler import record_function

from pbcore import checks, stats
from pbcore.cells import derive_seed
from pbcore.traffic import check_pixels, resolve
from pbref import judge
from pbref.tracer import Counts

#: the factor by which the ``altered`` fault changes an answer
ALTER = 1.05


class Frames:
    kind = "frames"
    first = 0

    def __init__(self, mix, scene, camera, seed):
        self.mix, self.scene, self.camera, self.seed = mix, scene, camera, seed
        self.render = resolve("render.render")
        w, h = mix["width"], mix["height"]
        self.pixels = check_pixels(mix, seed)
        # image row of a bottom-up flat index: top-down, so flipped
        self.rows = h - 1 - self.pixels // w
        self.cols = self.pixels % w
        self.kept = {}  # frame index -> (P, 3) uint8 at the checked pixels

    def samples(self) -> int:
        m = self.mix
        return m["width"] * m["height"] * m["spp"]

    def frame_seed(self, i: int) -> int:
        return derive_seed(self.seed, "frame", i)

    def __call__(self, i: int) -> None:
        m = self.mix
        with record_function("pb.frame"):
            img = self.render(self.scene, self.camera, m["width"], m["height"],
                              samples_per_pixel=m["spp"],
                              max_depth=m["max_depth"],
                              seed=self.frame_seed(i), tonemap=m["tonemap"],
                              engine=m["engine"],
                              **m.get("render_kwargs", {}))
        if (not isinstance(img, np.ndarray) or img.dtype != np.uint8
                or img.shape != (m["height"], m["width"], 3)):
            raise ValueError(f"frame {i}: not an ({m['height']}, "
                             f"{m['width']}, 3) uint8 image")
        self.kept[i] = img[self.rows, self.cols].copy()

    def warm(self) -> None:
        for k in range(self.mix["warm_frames"]):
            self(-1 - k)
        self.kept.clear()

    def judged(self, done):
        """The checked pixels of ``check_frames`` of the finished frames,
        drawn from the seed, and what the reference needs to redo them."""
        rng = np.random.default_rng(derive_seed(self.seed, "check"))
        pool = sorted(c.index for c in done)
        picked = sorted(rng.choice(pool, size=min(self.mix["check_frames"],
                                                  len(pool)),
                                   replace=False).tolist())
        return ([self.kept[i] for i in picked],
                dict(pixels=self.pixels,
                     seeds=[self.frame_seed(i) for i in picked]))

    def release(self) -> None:
        self.scene = self.camera = None
        self.kept.clear()

    def end_to_end(self, calls, done, window_s) -> dict:
        return stats.frame_metrics([c.seconds for c in calls],
                                   self.samples() * len(done), window_s)

    def readings(self) -> dict:
        return {}


def make(mix, scene, camera, seed):
    return Frames(mix, scene, camera, seed)


def reference(cfg, parts, mix, request, device, dtype=torch.float32):
    """The reference's uint8 values of the checked pixels, and the work
    it counted there (segments and hits, with the scale to the frame)."""
    counts = Counts()
    out, info = judge.frame_pixels(cfg, parts, mix, request["pixels"],
                                   request["seeds"], device, dtype=dtype,
                                   counts=counts)
    samples = mix["width"] * mix["height"] * mix["spp"]
    return out, dict(segments=counts.segments, hits=counts.hits,
                     scale=samples / (info["pixels"] * mix["spp"]))


compare = checks.frames


def half(tr):
    """Half of the batch left out, the mean taken over the rest: each
    frame rendered at half its samples."""
    render = tr.render

    @functools.wraps(render)
    def halved(*args, samples_per_pixel, **kw):
        return render(*args, samples_per_pixel=max(1, samples_per_pixel
                                                   // 2), **kw)

    tr.render = halved


def altered(tr):
    """Every answer altered where it is produced: the frame's radiance
    times :data:`ALTER` before the tone map."""
    render_mod = importlib.import_module("spira_tpu_torch.render")
    engine = render_mod.render_flat_engine

    def scaled(*args, **kw):
        return engine(*args, **kw) * ALTER

    render_mod.render_flat_engine = scaled
    tr.restore = lambda: setattr(render_mod, "render_flat_engine", engine)


#: faults planted under the timed path (tests and calibration only)
FAULTS = {"half": half, "altered": altered}
