"""The port's PCG4D hash against spira_tpu.core.pcg: bit-exact draws."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spira_tpu.core import pcg as jpcg
from spira_tpu_torch.core import pcg as tpcg

torch.set_num_threads(1)

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)


def _counters(seed, n=4096):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    # every edge value meets every other in each position
    grid = np.stack(np.meshgrid(EDGES, EDGES, EDGES, EDGES, indexing="ij"))
    return np.concatenate([c, grid.reshape(4, -1)], axis=1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg4d_bit_exact(seed):
    c = _counters(seed)
    ref = jpcg.pcg4d(*(jnp.asarray(x) for x in c))
    got = tpcg.pcg4d(*(_t(x) for x in c))
    for r, g in zip(ref, got):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(_u32(g), np.asarray(r))


def test_mul32_low_bits_of_large_products():
    """Products of values >= 2**31 overflow int64; _mul32 keeps the exact
    low 32 bits."""
    x = np.array([2**31, 2**32 - 1, 0xDEADBEEF, 3], np.uint64)
    y = np.array([2**31 + 5, 2**32 - 1, 0xCAFEBABE, 2**32 - 1], np.uint64)
    want = [(int(a) * int(b)) & 0xFFFFFFFF for a, b in zip(x, y)]
    got = tpcg._mul32(_t(x), _t(y)).tolist()
    assert got == want


def test_to_uniform_bit_exact():
    bits = _counters(2)[0]
    ref = np.asarray(jpcg.to_uniform(jnp.asarray(bits)))
    got = tpcg.to_uniform(_t(bits)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize(
    "sample,stream,seed",
    [(0, 0, 0), (3, 7, 42), (2**31, 2**32 - 1, -1), (15, 12, 2**31 - 1)],
)
def test_uniform4_bit_exact(sample, stream, seed):
    """Scalar sample/stream/seed broadcast over the pixel counters; a
    negative seed wraps to u32 as the JAX package's int32 seed does."""
    pixel = _counters(3)[0]
    ref = jpcg.uniform4(
        jnp.asarray(pixel), np.uint32(sample), np.uint32(stream),
        jnp.int32(seed),
    )
    got = tpcg.uniform4(_t(pixel), sample, stream, seed)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_box_muller_close():
    """log/cos/sin differ by an ULP between XLA and PyTorch: 1e-6."""
    u = tpcg.uniform4(_t(_counters(4)[0]), 1, 2, 3)
    ref = jpcg.box_muller(jnp.asarray(u[0].numpy()), jnp.asarray(u[1].numpy()))
    got = tpcg.box_muller(u[0], u[1])
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
