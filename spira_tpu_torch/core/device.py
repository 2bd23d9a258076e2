"""Where the public constructors put their tensors.

The port's entry points run on the card unless the caller asks for the
CPU: a scene or camera constructor given ``device=None`` builds on CUDA,
and on a host without CUDA it raises instead of quietly building on the
CPU (where every render would run the plain PyTorch tracer).  Host-side
builders (the BVH builders and packers, ``icosphere``, ``load_obj_mesh``)
keep their tables on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.  Asking
    for CUDA, by default or by name, on a host without it raises: nothing
    falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device "
            "(torch.cuda.is_available() is False); the port runs on the "
            "card unless asked otherwise: pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return device


_CONSTANTS: dict = {}


def device_constant(name: str, values, device) -> torch.Tensor:
    """The constant table ``name`` (``values``, a NumPy array that never
    changes under that name) as a tensor on ``device``, copied there once
    and returned from then on: a frame that reads it makes no copy from
    host memory (on the card, a copy from pageable memory waits for the
    stream).  The tensor is shared; callers never write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(values)).to(device)
        _CONSTANTS[key] = t
    return t
