"""``steps``: an inverse-rendering loop.  Each call renders through the
differentiable entry the mix names (``forward``, with its
``forward_kwargs``), takes the MSE against a target frame of the true
materials rendered in set-up, its gradients by ``torch.autograd``, one
``torch.optim.Adam`` step and each leaf's clamp (``diff/inverse.py``'s:
albedo to [0, 1], emission to at least 0).  The leaves are the
materials' fields in ``leaves``, each with its ``start`` and ``clamp``.
The first ``check_steps`` calls run in set-up, through the window's own
call, and the reference follows them (:func:`pbref.judge.follow_steps`):
``loss_gap``, ``grad_gap`` and ``change_gap``."""

from __future__ import annotations

import functools
import math

import torch
from torch.profiler import record_function

from pbcore import checks, stats
from pbcore.cells import derive_seed
from pbcore.traffic import resolve
from pbref import judge
from pbref.tracer import Counts

#: the factor by which the ``altered`` fault changes an answer
ALTER = 1.05


class Steps:
    kind = "steps"

    def __init__(self, mix, scene, camera, seed):
        from spira_tpu_torch.render import with_fields

        self.mix, self.scene, self.camera, self.seed = mix, scene, camera, seed
        self.first = mix["check_steps"]
        self.with_fields = with_fields
        self.forward = resolve(mix["forward"])
        self.target_seed = derive_seed(seed, "target")
        render_flat = resolve("render.render_flat_engine")
        with torch.no_grad(), record_function("pb.target"):
            self.target = render_flat(
                scene, camera, width=mix["width"], height=mix["height"],
                spp=mix["spp"], max_depth=mix["max_depth"],
                seed=self.target_seed, engine=mix["engine"])
        self.leaves = {k: torch.full_like(getattr(scene.materials, k),
                                          v["start"])
                       for k, v in mix["leaves"].items()}
        self.start = {k: v.clone() for k, v in self.leaves.items()}
        for v in self.leaves.values():
            v.requires_grad_(True)
        self.opt = torch.optim.Adam(list(self.leaves.values()),
                                    lr=mix["lr"], foreach=False)
        self.losses = {}  # step index -> loss (first steps)
        self.first_grads = None  # leaf -> gradient, from Adam's state
        self.after = None  # leaf -> value after the first steps
        self.events = None  # [(e0, e1, e2, e3)] when timing the layers

    def step_seed(self, i: int) -> int:
        return derive_seed(self.seed, "step", i)

    def __call__(self, i: int) -> None:
        m = self.mix
        ev = None
        if self.events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
        fields = {("materials", k): v for k, v in self.leaves.items()}
        scene, camera = self.with_fields(self.scene, self.camera, fields)
        with record_function("pb.forward"):
            img = self.forward(scene, camera, width=m["width"],
                               height=m["height"], spp=m["spp"],
                               max_depth=m["max_depth"],
                               seed=self.step_seed(i),
                               **m["forward_kwargs"])
        if ev:
            ev[1].record()
        with record_function("pb.loss"):
            loss = torch.mean((img - self.target) ** 2)
        if ev:
            ev[2].record()
        tensors = list(self.leaves.values())
        with record_function("pb.backward"):
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        if ev:
            ev[3].record()
            self.events.append(ev)
        with record_function("pb.optimizer"):
            for p, g in zip(tensors, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                for k, p in self.leaves.items():
                    low, high = m["leaves"][k]["clamp"]
                    if low is not None or high is not None:
                        p.clamp_(min=low, max=high)
        value = float(loss.detach())  # the caller waits for its result
        if img.shape != self.target.shape or not math.isfinite(value) or any(
                not bool(torch.isfinite(p).all()) for p in tensors):
            raise ValueError(f"step {i}: non-finite or misshapen result")
        if i < m["check_steps"]:
            self.losses[i] = value
            if i == 0:
                self.first_grads = {k: self._first_grad(p)
                                    for k, p in self.leaves.items()}
            if i == m["check_steps"] - 1:
                self.after = {k: p.detach().clone()
                              for k, p in self.leaves.items()}

    def _first_grad(self, p):
        """The gradient the optimizer got at its first step, worked out
        from its state (Adam's first moment after one step is
        (1 - beta1) times it); zeros where it holds none."""
        state = self.opt.state.get(p, {})
        if "exp_avg" not in state:
            return torch.zeros_like(p.detach())
        return (state["exp_avg"] / (1.0 - self.opt.defaults["betas"][0])
                ).clone()

    def warm(self) -> None:
        """The first steps of the loop, through the window's own call:
        they compile, and they are the steps the reference follows."""
        for i in range(self.mix["check_steps"]):
            self(i)

    def time_layers(self) -> None:
        """Time each step's forward and backward with CUDA events."""
        self.events = []

    def judged(self, done):
        n = self.mix["check_steps"]
        return (dict(losses=[self.losses[i] for i in range(n)],
                     first_grads=self.first_grads, start=self.start,
                     after=self.after),
                dict(step_seeds=[self.step_seed(i) for i in range(n)],
                     target_seed=self.target_seed))

    def release(self) -> None:
        self.scene = self.camera = self.target = self.opt = None
        self.leaves = None

    def end_to_end(self, calls, done, window_s) -> dict:
        return stats.step_metrics(len(done), window_s)

    def readings(self) -> dict:
        """``layer_ms``: the mean forward and backward milliseconds of the
        timed steps."""
        if not self.events:
            return {}
        fwd = [e[0].elapsed_time(e[1]) for e in self.events]
        bwd = [e[2].elapsed_time(e[3]) for e in self.events]
        return dict(layer_ms=(sum(fwd) / len(fwd), sum(bwd) / len(bwd)))


def make(mix, scene, camera, seed):
    return Steps(mix, scene, camera, seed)


def reference(cfg, parts, mix, request, device, dtype=torch.float32):
    """The reference's first steps, and the work it counted in the first
    step's forward (segments and hits over the whole frame)."""
    counts = Counts()
    out = judge.follow_steps(cfg, parts, mix, request["step_seeds"],
                             request["target_seed"], device, dtype=dtype,
                             counts=counts)
    return out, dict(segments=counts.segments, hits=counts.hits)


compare = checks.steps


def unchanged(tr):
    """A step that leaves the state as it was: the optimizer does
    nothing."""
    tr.opt.step = lambda *a, **k: None


def half(tr):
    """Half of the batch left out, the mean taken over the rest: half of
    the samples of the forward and of the replay."""
    forward = tr.forward

    @functools.wraps(forward)
    def halved_step(*args, spp, grad_spp, **kw):
        return forward(*args, spp=max(1, spp // 2),
                       grad_spp=max(1, grad_spp // 2), **kw)

    tr.forward = halved_step


def altered(tr):
    """Every answer altered where it is produced: the step's image times
    :data:`ALTER`."""
    forward = tr.forward

    @functools.wraps(forward)
    def scaled_step(*args, **kw):
        return forward(*args, **kw) * ALTER

    tr.forward = scaled_step


#: faults planted under the timed path (tests and calibration only)
FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
