"""Frozen dataclasses of tensors — the port's counterpart of the pytrees.

The JAX package registers its scene model as pytrees
(:mod:`spira_tpu.core.types`).  PyTorch needs no registration: a scene
object is a frozen dataclass whose fields are tensors (or nested such
dataclasses, or static Python values), moved as a whole with ``.to``.
"""

from __future__ import annotations

import dataclasses

import torch


def tensor_dataclass(cls):
    """Make ``cls`` a frozen dataclass with a ``to(device)`` method that
    moves every tensor field (nested dataclasses included); other fields
    are kept as they are."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def to(self, device):
        moved = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if hasattr(type(value), "to"):  # tensors and tensor dataclasses
                value = value.to(device)
            moved[f.name] = value
        return dataclasses.replace(self, **moved)

    cls.to = to
    return cls


def replace(obj, **kwargs):
    """Functional field update for the frozen dataclasses."""
    return dataclasses.replace(obj, **kwargs)


def requires_grad(*objs) -> bool:
    """Whether any tensor among ``objs`` (tensors, tensor dataclasses,
    nested ones, tuples of them) requires grad: what decides whether a
    checkpoint would save anything."""
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            if obj.requires_grad:
                return True
        elif isinstance(obj, (tuple, list)):
            if requires_grad(*obj):
                return True
        elif dataclasses.is_dataclass(obj):
            if requires_grad(*(getattr(obj, f.name)
                               for f in dataclasses.fields(obj))):
                return True
    return False
