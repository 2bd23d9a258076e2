"""``exact``: the gradient of the forward's own samples, as kernel #6
replays them at exact replay (``grad_spp`` = ``spp``): sum(image * cot)
differentiated through the kernel tracer, in batches of samples under
autograd."""

import numpy as np
import torch

from pbref import tracer

#: lanes a batch holds under autograd
GRAD_LANES = 1 << 20


def grads(scene, cam, leaves, cot, mix, seed):
    """Gradients of sum(image * cot) with respect to ``leaves`` (the
    image the mean of the forward's ``spp`` samples)."""
    w, h, spp = mix["width"], mix["height"], mix["spp"]
    pix = torch.arange(w * h, device=cot.device)
    per = max(1, min(spp, GRAD_LANES // (w * h)))
    inv = float(np.float32(1.0 / spp))
    out = [torch.zeros_like(v) for v in leaves.values()]
    for s0 in range(0, spp, per):
        s1 = min(spp, s0 + per)
        smp = torch.arange(s0, s1, device=cot.device).repeat_interleave(w * h)
        sc = scene.with_materials(**leaves)
        r, g, b = tracer.trace_lanes(sc, cam, pix.repeat(s1 - s0), smp,
                                     width=w, height=h,
                                     max_depth=mix["max_depth"], seed=seed)
        rgb = torch.stack([r, g, b], -1).reshape(s1 - s0, w * h, 3)
        part = torch.autograd.grad((rgb * cot[None]).sum() * inv,
                                   list(leaves.values()), allow_unused=True)
        out = [a if p is None else a + p for a, p in zip(out, part)]
    return out
