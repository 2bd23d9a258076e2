"""Counter-based sampling (threefry2x32) for the wavefront estimator.

Counterpart of :mod:`spira_tpu.core.rng`, drawing JAX's own bits: every
draw is a pure function of ``(seed, sample_index, bounce_index, stream)``
and the ray's position in the wavefront array, so the port's estimator
traces the same paths as the JAX package's from the same seed.

JAX's recipe (``jax.random`` with ``jax_threefry_partitionable``, the
default since JAX 0.5):

* ``jax.random.key(seed)`` is the key ``[0, seed]`` (uint32 words);
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``, the two
  output words being the new key;
* the 32 random bits of element ``i`` of a shape (row-major) are
  ``y0 ^ y1`` of ``threefry2x32(key, (hi(i), lo(i)))``;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1; ``normal`` is ``sqrt(2) * erfinv(u)`` of a uniform
  ``u`` in ``(-1, 1)``.

A key is a pair of Python ints.  Keys are derived on the host (the seed,
sample, bounce and stream are Python ints), so only the per-element
bits run on the device: threefry's 32-bit words are held in ``int64``
tensors and masked to 32 bits after each add and shift, since torch's
``uint32`` lacks some of these operations and ``>>`` on ``int32`` is
arithmetic.  Every operation is exact, so the bits equal JAX's on any
device; ``normal`` goes through torch's ``erfinv``, which differs from
XLA's float32 polynomial by up to about 5e-6 relative.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from ..utils.profiling import annotate
from . import vecmath as vm
from .device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the lower end of ``normal``'s uniform: nextafter(-1, 0) in float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
#: its width, 1 - lo, rounded to float32 as JAX computes it
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


class Stream(enum.IntEnum):
    """Draw sites within one bounce (the 'stream' axis of the counter)."""

    PIXEL_JITTER = 0  # 2 uniforms for sub-pixel uv jitter
    LOBE_SELECT = 1  # metallic-vs-diffuse branch
    DIFFUSE_DIR = 2  # diffuse scatter direction
    METAL_FUZZ = 3  # roughness perturbation of the mirror direction
    ROULETTE = 4  # Russian-roulette continuation draw
    WAVELENGTH = 5  # hero-wavelength selection (spectral renderer)
    LENS = 6  # aperture / depth-of-field disk sample


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``: Python ints or int64 tensors holding 32-bit
    words.  Returns the two output words."""
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
    """``jax.random.fold_in``: threefry of the key over ``(0, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def base_key(seed) -> tuple:
    """Root key for a render, ``jax.random.key`` of a uint32 seed: the key
    ``(0, seed)``; everything else is folded in from here."""
    return (0, int(seed) & _MASK)


def sample_key(k, sample_idx) -> tuple:
    return fold_in(k, sample_idx)


def bounce_key(skey, bounce_idx, stream: Stream) -> tuple:
    return fold_in(fold_in(skey, bounce_idx), int(stream))


def random_bits(k, shape, device=None) -> torch.Tensor:
    """JAX's 32 random bits for ``shape`` under key ``k``, as an int64
    tensor of values in [0, 2**32) on ``device`` (``None``: the card)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: the counter's high word is not "
                         "ported")
    with annotate("spira.rng.threefry"):
        lo = torch.arange(n, dtype=torch.int64,
                          device=resolve_device(device))
        y0, y1 = threefry2x32(k[0], k[1], 0, lo)
        return (y0 ^ y1).reshape(shape)


def uniform(k, shape=(), device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)``: [0, 1), bit-exact."""
    bits = random_bits(k, shape, device)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one_to_two.view(torch.float32) - 1.0


def uniform_box3(k, shape, device=None) -> torch.Tensor:
    """Uniform in [0, 1)^3: ``shape + (3,)``."""
    return uniform(k, tuple(shape) + (3,), device)


def normal(k, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: the uniform bits are
    JAX's; ``erfinv`` is torch's (up to about 5e-6 relative from XLA's)."""
    u = uniform(k, shape, device) * _NORMAL_SPAN + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return _SQRT2 * torch.erfinv(u)


def unit_vector(k, shape, device=None) -> torch.Tensor:
    """Uniform direction on the unit sphere: a normalized Gaussian."""
    return vm.normalize(normal(k, tuple(shape) + (3,), device))


def cosine_hemisphere(k, normal_dir) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about unit ``normal_dir``
    (..., 3), by projecting a disk sample up."""
    shape = tuple(normal_dir.shape[:-1])
    r = uniform(k, shape + (2,), normal_dir.device)
    phi = 2.0 * math.pi * r[..., 0]
    sq = torch.sqrt(r[..., 1])
    x = torch.cos(phi) * sq
    y = torch.sin(phi) * sq
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    u, v = vm.orthonormal_basis(normal_dir)
    return vm.normalize(x[..., None] * u + y[..., None] * v
                        + z[..., None] * normal_dir)
