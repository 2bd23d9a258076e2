"""Threefry-2x32 sampling of the port's wavefront estimator.

Frozen copy of ``spira_tpu_torch/core/rng.py`` at commit 86df806 (the
draws of ``jax.random`` with partitionable threefry, held in int64
tensors): every draw is a pure function of (seed, sample, bounce, stream)
and the ray's position in the wavefront.  The uniforms are made in
float32 and cast to the precision the reference runs in.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from . import vec

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


class Stream(enum.IntEnum):
    PIXEL_JITTER = 0
    LOBE_SELECT = 1
    DIFFUSE_DIR = 2
    METAL_FUZZ = 3
    ROULETTE = 4
    WAVELENGTH = 5
    LENS = 6


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(k, data) -> tuple:
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def base_key(seed) -> tuple:
    return (0, int(seed) & _MASK)


def sample_key(k, sample_idx) -> tuple:
    return fold_in(k, sample_idx)


def bounce_key(skey, bounce_idx, stream: Stream) -> tuple:
    return fold_in(fold_in(skey, bounce_idx), int(stream))


def random_bits(k, shape, device) -> torch.Tensor:
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], 0, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(k, shape, device, dtype=torch.float32) -> torch.Tensor:
    bits = random_bits(k, shape, device)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return (one_to_two.view(torch.float32) - 1.0).to(dtype)


def normal(k, shape, device, dtype=torch.float32) -> torch.Tensor:
    u = uniform(k, shape, device) * _NORMAL_SPAN + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return (_SQRT2 * torch.erfinv(u)).to(dtype)


def unit_vector(k, shape, device, dtype=torch.float32) -> torch.Tensor:
    return vec.normalize(normal(k, tuple(shape) + (3,), device, dtype))


def cosine_hemisphere(k, normal_dir) -> torch.Tensor:
    shape = tuple(normal_dir.shape[:-1])
    r = uniform(k, shape + (2,), normal_dir.device, normal_dir.dtype)
    phi = 2.0 * math.pi * r[..., 0]
    sq = torch.sqrt(r[..., 1])
    x = torch.cos(phi) * sq
    y = torch.sin(phi) * sq
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    u, v = vec.orthonormal_basis(normal_dir)
    return vec.normalize(x[..., None] * u + y[..., None] * v
                         + z[..., None] * normal_dir)
