"""PCG4D counter hash — the tracer's RNG, as torch tensor ops.

The same pcg4d hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) as :mod:`spira_tpu.core.pcg`, bit for bit: every draw is a pure
function of (pixel, sample, bounce·stream, seed), so renders replay exactly
and the CUDA kernel (``csrc/pcg.cuh``, native ``uint32_t``) and this plain
version draw the same numbers.

PyTorch on the CPU has no ``add`` and no ``>>`` for ``uint32``, so the hash
runs on int64 tensors holding values in ``[0, 2**32)``, masked back to 32
bits after every operation.  The product of two such values does not fit in
int64, so :func:`_mul32` splits one factor into 16-bit halves; every partial
product stays below 2**48.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223
#: 2**-24: ``to_uniform`` keeps the top 24 bits, which float32 holds exactly.
_INV_2_24 = 1.0 / (1 << 24)
#: float32(2π), the constant the JAX package multiplies by.
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mul32(x, y):
    """(x * y) mod 2**32 for int64 tensors holding u32 values."""
    lo = (x & 0xFFFF) * y
    hi = (((x >> 16) * (y & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(x, like=None):
    """Tensor or int → int64 tensor of u32 values (negative ints wrap)."""
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
    """pcg4d hash: four u32 counters → four decorrelated u32s (int64)."""
    a, b, c, d = (
        (as_u32(x) * _MUL + _INC) & _M32 for x in (a, b, c, d)
    )
    a, b, c, d = _mix(a, b, c, d)
    a, b, c, d = (x ^ (x >> 16) for x in (a, b, c, d))
    return _mix(a, b, c, d)


def to_uniform(bits):
    """u32 (int64) → float32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def uniform4(pixel, sample, stream, seed):
    """Four independent U[0,1) draws per lane.

    pixel: per-lane counter tensor; sample/stream/seed: ints or tensors
    broadcastable to it.
    """
    shape = pixel.shape
    a, b, c, d = pcg4d(
        pixel,
        torch.broadcast_to(as_u32(sample, pixel), shape),
        torch.broadcast_to(as_u32(stream, pixel), shape),
        torch.broadcast_to(as_u32(seed, pixel), shape),
    )
    return to_uniform(a), to_uniform(b), to_uniform(c), to_uniform(d)


def box_muller(u1, u2):
    """Two standard normals from two uniforms."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    theta = TWO_PI_F32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)
