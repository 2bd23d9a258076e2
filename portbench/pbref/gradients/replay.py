"""``replay``: the wavefront's mean of ``grad_spp`` threefry samples
drawn from the step's seed, differentiated as the mesh step's backward
replays them (:func:`pbref.wavefront.replay_mean`)."""

import torch

from pbref import wavefront


def grads(scene, cam, leaves, cot, mix, seed):
    out = wavefront.replay_mean(
        scene.with_materials(**leaves), cam, width=mix["width"],
        height=mix["height"], spp=mix["forward_kwargs"]["grad_spp"],
        max_depth=mix["max_depth"], seed=seed)
    return torch.autograd.grad(out, list(leaves.values()), cot,
                               allow_unused=True)
