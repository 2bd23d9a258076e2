"""The peak-rate probes' plain versions (kernels #9 and #10) against their
JAX counterparts, and their operation counts against the JAX scripts.

Both JAX kernel bodies are closures inside ``main()`` of
``benchmarks/vpu_peak.py`` and ``benchmarks/packet_profile.py``, so there
is no function to import: each test holds the plain version to a ``jnp``
restatement of the kernel body, run by XLA on the CPU, and to a NumPy
float32 oracle that rounds every operation as the card's kernel does
(``-fmad=false``).  Limits:

* NumPy oracle: bit-equal (the same float32 operations in the same order).
* ``jnp`` restatement of #9 at the JAX probe's input (ones): bit-equal; at
  a random input, rtol 2e-4: XLA's CPU backend contracts ``x * c + b``
  into one FMA, so each of the 2,000 steps rounds once where the kernel
  rounds twice (measured here: max abs 5.7e-3 on sums near 40).
* ``jnp`` restatement of #10 in float32 at the JAX input (0.5): rtol 2e-7
  (one unit in the last place; XLA's contraction again).  In bfloat16 the
  restatement puts an optimization barrier around each operation, so XLA
  rounds each to bfloat16 as the TPU does: bit-equal.  Without the
  barriers XLA keeps float32 between the operations (128.5 where per-op
  bfloat16 rounding sticks at 128.0), which the last test records.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spira_tpu_torch.bench import packet_profile as pp
from spira_tpu_torch.bench import vpu_peak as vp

torch.set_num_threads(1)

REPO = __file__.rsplit("/tests/", 1)[0]


def _jax_peak(x):
    """``benchmarks/vpu_peak.py:31-46``, restated."""
    xs = [x + jnp.float32(i) for i in range(vp.CHAINS)]

    def body(i, xs):
        return tuple(
            jnp.minimum(x * jnp.float32(1.000001) + jnp.float32(1e-7),
                        jnp.float32(1e30))
            for x in xs)

    xs = jax.lax.fori_loop(0, vp.ITERS, body, tuple(xs))
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _jax_dtype(x, dtype, barrier):
    """``benchmarks/packet_profile.py:94-101``, restated; ``barrier``
    keeps XLA from fusing across operations."""
    bar = jax.lax.optimization_barrier if barrier else (lambda v: v)
    x = x.astype(dtype)
    acc = x
    c1 = jnp.asarray(pp.C1, dtype)
    c2 = jnp.asarray(pp.C2, dtype)
    for _ in range(pp.CHAIN):
        acc = bar(bar(acc * c1) + bar(x * c2))
    return acc.astype(jnp.float32)


def _numpy_peak(x, iters=vp.ITERS):
    ch = np.stack([x + np.float32(k) for k in range(vp.CHAINS)])
    for _ in range(iters):
        ch = np.minimum((ch * np.float32(1.000001)).astype(np.float32)
                        + np.float32(1e-7), np.float32(1e30))
    acc = ch[0]
    for k in range(1, vp.CHAINS):
        acc = acc + ch[k]
    return acc


def test_peak_separate_matches_jax_and_numpy():
    """#9, mode separate, at the JAX shape: bit-equal to the restatement
    at the JAX input (ones) and to the NumPy oracle at a random one;
    within rtol 2e-4 of the restatement there (XLA contracts)."""
    ones = np.ones(vp.JAX_SHAPE, np.float32)
    got = vp.vpu_peak(torch.from_numpy(ones)).numpy()
    want = np.asarray(jax.jit(_jax_peak)(ones))
    assert got.shape == vp.JAX_SHAPE
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(0).uniform(0.5, 4.0, vp.JAX_SHAPE).astype(
        np.float32)
    got = vp.vpu_peak(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _numpy_peak(x))
    np.testing.assert_allclose(got, np.asarray(jax.jit(_jax_peak)(x)),
                               rtol=2e-4)


def _fma32(a, b, c):
    """float32(a * b + c) rounded once (ties to even), exactly."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    lo, hi = np.nextafter(f, np.float32(-np.inf)), np.nextafter(
        f, np.float32(np.inf))
    best = min((abs(Fraction(float(v)) - exact), v) for v in (lo, f, hi))
    ties = [v for v in (lo, f, hi)
            if abs(Fraction(float(v)) - exact) == best[0]]
    if len(ties) > 1:  # ties to even
        return next(v for v in ties
                    if not int(np.array(v).view(np.int32)) & 1)
    return best[1]


def test_peak_contracted_rounds_once():
    """#9, mode contracted: each step is fmaf's single rounding (an exact
    rational oracle) on 64 random chains of 20 steps, within 1 ulp (the
    plain version rounds a float64 sum, which may round twice)."""
    x = np.random.default_rng(1).uniform(0.5, 4.0, 64).astype(np.float32)
    got = vp.vpu_peak(torch.from_numpy(x), "contracted", iters=20).numpy()
    c, b = np.float32(1.000001), np.float32(1e-7)
    acc = None
    for k in range(vp.CHAINS):
        ch = x + np.float32(k)
        for _ in range(20):
            ch = np.minimum(np.array([_fma32(v, c, b) for v in ch],
                                     np.float32), np.float32(1e30))
        acc = ch if acc is None else acc + ch
    ulp = np.abs(got.view(np.int32) - acc.view(np.int32))
    assert ulp.max() <= 1


@pytest.mark.parametrize("mode", vp.SPECIAL)
def test_peak_special_chains_stay_finite(mode):
    """The special-function chains stay finite over the full run and are
    each one call a step (checked against the same chain in NumPy)."""
    x = torch.ones(vp.JAX_SHAPE)
    got = vp.vpu_peak(x, mode)
    assert got.shape == x.shape and torch.isfinite(got).all()
    one = {"sqrt": np.sqrt, "div": lambda v: np.float32(1) / v,
           "exp": lambda v: np.exp(-v), "log": lambda v: np.log(v) + 2,
           "sin": np.sin, "cos": np.cos}[mode]
    ch = np.arange(vp.CHAINS, dtype=np.float32) + np.float32(1)
    for _ in range(vp.ITERS):
        ch = one(ch).astype(np.float32)
    np.testing.assert_allclose(float(got[0, 0]), float(ch.sum()),
                               rtol=1e-5, atol=1e-6)


def test_dtype_matches_jax():
    """#10 at the JAX tile and input: float32 within rtol 2e-7 of the
    restatement (bit-equal to the NumPy oracle), bfloat16 bit-equal to
    the restatement with a barrier around each operation."""
    x = np.full((pp.ROWS, pp.COLS), 0.5, np.float32)
    f32 = pp.vpu_dtype(torch.from_numpy(x), "f32").numpy()
    acc = x.copy()
    for _ in range(pp.CHAIN):
        acc = ((acc * np.float32(pp.C1)).astype(np.float32)
               + (x * np.float32(pp.C2)).astype(np.float32))
    np.testing.assert_array_equal(f32, acc)
    want = np.asarray(jax.jit(lambda v: _jax_dtype(v, jnp.float32,
                                                   False))(x))
    np.testing.assert_allclose(f32, want, rtol=2e-7)
    bf16 = pp.vpu_dtype(torch.from_numpy(x), "bf16").numpy()
    want = np.asarray(jax.jit(lambda v: _jax_dtype(v, jnp.bfloat16,
                                                   True))(x))
    np.testing.assert_array_equal(bf16, want)
    assert bf16.dtype == np.float32 and bf16.shape == x.shape
    # bfloat16 has 8 significant bits: adding 0.5 to 128 rounds back down
    assert float(bf16[0, 0]) == 128.0


def test_dtype_bf16_without_barriers_keeps_excess_precision():
    """The literal restatement in bfloat16: XLA's CPU backend keeps
    float32 between the operations and lands on 128.5, half a unit from
    the per-op rounding's 128.0; the figure the unbarriered comparison
    allows."""
    x = np.full((8, 128), 0.5, np.float32)
    want = np.asarray(jax.jit(lambda v: _jax_dtype(v, jnp.bfloat16,
                                                   False))(x))
    got = pp.vpu_dtype(torch.from_numpy(x), "bf16").numpy()
    np.testing.assert_allclose(got, want, atol=0.5)


def test_op_counts_match_jax_scripts():
    """The counted operations per launch, as the JAX scripts count them
    (``vpu_peak.py:68``: 3 lane-ops per chain-iteration;
    ``packet_profile.py:123``: 2 flops per step), with the scripts' shapes
    read from their sources."""
    with open(f"{REPO}/benchmarks/vpu_peak.py") as f:
        peak_src = f.read()
    with open(f"{REPO}/benchmarks/packet_profile.py") as f:
        prof_src = f.read()
    assert "TILE = (32, 128)" in peak_src and "ITERS = 2000" in peak_src
    assert "CHAINS = 8" in peak_src
    assert "ops = 3 * CHAINS * ITERS * lanes" in peak_src
    assert "ROWS, COLS, CHAIN = 256, 128, 512" in prof_src
    assert "ops = 2 * CHAIN * ROWS * COLS" in prof_src
    assert vp.JAX_SHAPE == (32, 128)
    assert (vp.CHAINS, vp.ITERS) == (8, 2000)
    assert (pp.ROWS, pp.COLS, pp.CHAIN) == (256, 128, 512)
    assert vp.ops_per_launch("separate", 32 * 128) == 3 * 8 * 2000 * 4096
    assert vp.ops_per_launch("contracted", 10) == 3 * 8 * 2000 * 10
    assert vp.ops_per_launch("sin", 10) == 8 * 2000 * 10
    assert pp.flops_per_launch(256 * 128) == 2 * 512 * 256 * 128
    assert vp.INSTRUCTIONS == {"separate": 3, "contracted": 2}
    assert pp.INSTRUCTIONS == {"f32": 2, "bf16": 1}


def test_probe_wrappers_refuse_bad_inputs():
    """Unknown modes and dtypes, non-float32 input, odd bf16 sizes on the
    card, and other devices raise; the CPU path launches nothing."""
    x = torch.ones(16)
    with pytest.raises(ValueError):
        vp.vpu_peak(x, "tan")
    with pytest.raises(ValueError):
        vp.vpu_peak(x.double())
    with pytest.raises(ValueError):
        pp.vpu_dtype(x, "f16")
    with pytest.raises(ValueError):
        pp.vpu_dtype(x.half())
    before = (vp.vpu_peak.launches, pp.vpu_dtype.launches)
    vp.vpu_peak(x, iters=3)
    pp.vpu_dtype(x, steps=3)
    assert (vp.vpu_peak.launches, pp.vpu_dtype.launches) == before
    with pytest.raises(ValueError):
        vp.vpu_peak(x.to("meta"))


def test_probe_input_varies_and_keeps_every_chain_finite():
    """The probes' input: reproducible from its seed, in [1, 2), varying
    by element; every mode of #9 stays finite from it over the full run,
    and #10 in both types."""
    x = vp.probe_input(4096, "cpu")
    assert torch.equal(x, vp.probe_input(4096, "cpu"))
    assert not torch.equal(x, vp.probe_input(4096, "cpu", seed=1))
    assert x.dtype == torch.float32 and 1.0 <= float(x.min())
    assert float(x.max()) < 2.0 and x.unique().numel() > 4000
    for mode in vp.MODES:
        assert torch.isfinite(vp.vpu_peak(x, mode)).all(), mode
    for dtype in pp.DTYPES:
        assert torch.isfinite(pp.vpu_dtype(x, dtype)).all(), dtype


def test_fit_costs_recovers_known_costs():
    """The least-squares fit of the counters tier on rows made from known
    per-unit costs (2 ns a pop, 1 ns a leaf triangle, 5 ns a walk)."""
    rows = [dict(pops=p, leaf_tris=t, traversals=w,
                 ms=(2 * p + t + 5 * w) * 1e-6)
            for p, t, w in ((18e6, 27e6, 6e6), (22e6, 16e6, 6.5e6),
                            (19e6, 9e6, 6.1e6), (10e6, 5e6, 2e6))]
    fit = pp.fit_costs(rows)
    assert fit["rank"] == 3
    assert fit["ns_per_pop"] == pytest.approx(2.0)
    assert fit["ns_per_leaf_tri"] == pytest.approx(1.0)
    assert fit["ns_per_traversal"] == pytest.approx(5.0)
    assert fit["residual"] == pytest.approx(0.0, abs=1e-12)
