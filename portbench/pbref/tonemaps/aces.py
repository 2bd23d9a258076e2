"""``aces``: the ACES filmic fit clamped to [0, 1], then its square root.
A frozen copy, at commit 86df806, of ``spira_tpu_torch/io/image.py:
aces_fit`` and ``tonemap_aces``."""

import torch


def apply(hdr):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = hdr
    return torch.sqrt(torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e),
                                  0.0, 1.0))
