"""PCG4D counter hash, the RNG of the port's path-tracing kernels.

Frozen copy of ``spira_tpu_torch/core/pcg.py`` at commit 86df806: every
draw is a pure function of (pixel, sample, bounce·stream, seed), so a
pixel's samples can be traced alone.  The hash runs on int64 tensors that
hold u32 values; ``to_uniform`` gives float32, which the reference casts
to the precision it runs in.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223
_INV_2_24 = 1.0 / (1 << 24)
#: float32(2π)
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mul32(x, y):
    lo = (x & 0xFFFF) * y
    hi = (((x >> 16) * (y & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(x, like=None):
    if not torch.is_tensor(x):
        device = like.device if like is not None else None
        x = torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def _mix(a, b, c, d):
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    return a, b, c, d


def pcg4d(a, b, c, d):
    a, b, c, d = ((as_u32(x) * _MUL + _INC) & _M32 for x in (a, b, c, d))
    a, b, c, d = _mix(a, b, c, d)
    a, b, c, d = (x ^ (x >> 16) for x in (a, b, c, d))
    return _mix(a, b, c, d)


def to_uniform(bits, dtype=torch.float32):
    return ((bits >> 8).to(torch.float32) * _INV_2_24).to(dtype)


def uniform4(pixel, sample, stream, seed, dtype=torch.float32):
    """Four U[0,1) draws per lane; ``sample``/``stream``/``seed`` are ints
    or tensors that broadcast to ``pixel``."""
    shape = pixel.shape
    a, b, c, d = pcg4d(
        pixel,
        torch.broadcast_to(as_u32(sample, pixel), shape),
        torch.broadcast_to(as_u32(stream, pixel), shape),
        torch.broadcast_to(as_u32(seed, pixel), shape),
    )
    return tuple(to_uniform(x, dtype) for x in (a, b, c, d))


def box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    theta = TWO_PI_F32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)
