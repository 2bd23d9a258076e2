"""Where the public constructors put their tensors.

The port's entry points run on the card unless the caller asks for the
CPU: a scene or camera constructor given ``device=None`` builds on CUDA,
and on a host without CUDA it raises instead of quietly building on the
CPU (where every render would run the plain PyTorch tracer).  Host-side
builders (the BVH builders and packers, ``icosphere``, ``load_obj_mesh``)
keep their tables on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the "
            "constructors build on the card unless asked otherwise; pass "
            "device='cpu' to build on the CPU"
        )
    return torch.device("cuda")
