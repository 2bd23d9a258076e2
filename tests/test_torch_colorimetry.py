"""The port's colorimetry against :mod:`spira_tpu.core.colorimetry`: the
host-side NumPy tables (Smits upsampling, Chebyshev fits, the SPD grid)
bit-equal, the torch functions within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spira_tpu.core import colorimetry as jcl
from spira_tpu_torch.core import colorimetry as tcl

torch.set_num_threads(1)

#: float32 functions evaluated by XLA and by torch: the same expressions,
#: possibly a different exp() in the last bit
RTOL = ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_constants_equal():
    for name in ("LAMBDA_MIN", "LAMBDA_MAX", "LAMBDA_RANGE", "N_WAVELENGTHS",
                 "N_SPD_BINS", "N_CHEB"):
        assert getattr(tcl, name) == getattr(jcl, name), name
    for name in ("SPD_GRID", "XYZ_TO_SRGB", "D65_WHITE"):
        got, want = getattr(tcl, name), getattr(jcl, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_rgb_to_spd_bit_equal():
    """256 seeded RGB triples, some above 1 (the scaled domain) and some
    with equal channels (the ordering ties), on the default grid and on
    a custom one."""
    rgb = _rng(1).uniform(0.0, 2.5, (256, 3)).astype(np.float32)
    rgb[:16] = np.round(rgb[:16] * 2.0) / 2.0  # ties between channels
    got, want = tcl.rgb_to_spd(rgb), jcl.rgb_to_spd(rgb)
    assert got.dtype == np.float32 and got.shape == (256, tcl.N_SPD_BINS)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    grid = np.linspace(400.0, 700.0, 7)
    np.testing.assert_array_equal(tcl.rgb_to_spd(rgb[:8], grid),
                                  jcl.rgb_to_spd(rgb[:8], grid))


@pytest.mark.parametrize("degree", [tcl.N_CHEB, 6])
def test_chebyshev_fit_bit_equal(degree):
    table = _rng(2).uniform(0.0, 3.0, (5, 4, tcl.N_SPD_BINS))
    got = tcl.chebyshev_fit(table, degree)
    assert got.shape == (5, 4, degree) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jcl.chebyshev_fit(table, degree))


def test_smits_tables_bit_equal():
    assert tcl.SMITS_CHEB.keys() == jcl.SMITS_CHEB.keys()
    for name in jcl.SMITS_CHEB:
        np.testing.assert_array_equal(tcl.SMITS_CHEB[name],
                                      jcl.SMITS_CHEB[name], err_msg=name)
        np.testing.assert_array_equal(tcl._SMITS_RESAMPLED[name],
                                      jcl._SMITS_RESAMPLED[name],
                                      err_msg=name)


def test_cmf_components():
    lam = _rng(3).uniform(350.0, 760.0, 1024).astype(np.float32)
    got = tcl.cmf_xyz_components(torch.from_numpy(lam))
    want = jcl.cmf_xyz_components(jnp.asarray(lam))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-7)
    np.testing.assert_allclose(tcl.cmf_xyz(torch.from_numpy(lam)).numpy(),
                               np.asarray(jcl.cmf_xyz(jnp.asarray(lam))),
                               rtol=RTOL, atol=1e-7)


def test_y_integral():
    np.testing.assert_allclose(tcl.Y_INTEGRAL, jcl.Y_INTEGRAL, rtol=1e-6)


def test_chebyshev_eval():
    rng = _rng(4)
    coeffs = rng.normal(size=(64, tcl.N_CHEB)).astype(np.float32)
    lam = rng.uniform(380.0, 730.0, 64).astype(np.float32)
    got = tcl.chebyshev_eval(torch.from_numpy(coeffs), torch.from_numpy(lam))
    want = jcl.chebyshev_eval(jnp.asarray(coeffs), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # a sequence of scalars broadcast over the wavelengths
    got = tcl.chebyshev_eval([float(c) for c in coeffs[0]],
                             torch.from_numpy(lam))
    want = jcl.chebyshev_eval([float(c) for c in coeffs[0]],
                              jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sample_spd_both_layouts():
    rng = _rng(5)
    table = rng.uniform(0.0, 2.0, (8, tcl.N_SPD_BINS)).astype(np.float32)
    lam = rng.uniform(370.0, 740.0, (8, 4)).astype(np.float32)  # clamped
    got = tcl.sample_spd(torch.from_numpy(table), torch.from_numpy(lam))
    want = jcl.sample_spd(jnp.asarray(table), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    got = tcl.sample_spd(torch.from_numpy(table[0]), torch.from_numpy(lam))
    want = jcl.sample_spd(jnp.asarray(table[0]), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_xyz_to_rgb_and_spectrum_to_xyz():
    rng = _rng(6)
    xyz = rng.uniform(0.0, 3.0, (128, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcl.xyz_to_rgb(torch.from_numpy(xyz)).numpy(),
        np.asarray(jcl.xyz_to_rgb(jnp.asarray(xyz))), rtol=RTOL, atol=ATOL)
    values = rng.uniform(0.0, 2.0, (128, 4)).astype(np.float32)
    lam = rng.uniform(380.0, 730.0, (128, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tcl.spectrum_to_xyz(torch.from_numpy(values),
                            torch.from_numpy(lam)).numpy(),
        np.asarray(jcl.spectrum_to_xyz(jnp.asarray(values),
                                       jnp.asarray(lam))),
        rtol=RTOL, atol=ATOL)


def test_flat_spectrum_is_white():
    """A flat unit spectrum integrates to Y = 1 and lands near sRGB
    (1, 1, 1) after the D65 adaptation (the reason for Y_INTEGRAL)."""
    lam = torch.linspace(tcl.LAMBDA_MIN, tcl.LAMBDA_MAX, 4096)[None, :]
    xyz = tcl.spectrum_to_xyz(torch.ones_like(lam), lam)
    assert abs(float(xyz[0, 1]) - 1.0) < 1e-3
    np.testing.assert_allclose(tcl.xyz_to_rgb(xyz)[0].numpy(), 1.0,
                               atol=0.05)
