"""``gamma``: the radiance clamped to [0, 1], then its square root.  A
frozen copy, at commit 86df806, of ``spira_tpu_torch/io/image.py:
tonemap_gamma``."""

import torch


def apply(hdr):
    return torch.sqrt(torch.clamp(hdr, 0.0, 1.0))
