"""The port's threefry draws against ``jax.random``, and the draws built on
them (raygen, the BSDF samplers) against the JAX package's.

Tolerances: key words and uniform bits are equal to the bit (integer
arithmetic); ``normal`` and what is built on it within 2e-5 relative /
1e-6 absolute (torch's float32 ``erfinv`` against XLA's polynomial, a
measured 5e-6 relative); raygen and scatter directions within 1e-6
absolute (float32 rounding of the same formulas: transcendentals and
summation order may differ in the last bit)."""

import jax
import numpy as np
import pytest
import torch

import spira_tpu as st
import spira_tpu_torch as sp
from spira_tpu.core import rng as jr
from spira_tpu.integrator import bsdf as jbsdf
from spira_tpu.scene.camera import generate_rays as j_generate_rays
from spira_tpu_torch.core import rng as tr
from spira_tpu_torch.integrator import bsdf as tbsdf

torch.set_num_threads(1)

NORMAL_RTOL, NORMAL_ATOL = 2e-5, 1e-6
DIR_ATOL = 1e-6
SEEDS = (0, 7, 123456789, 2**32 - 1)


def _key_words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _keys(seed):
    """The same key path in both packages: base, a large sample index, a
    nonzero row_start, a bounce and stream."""
    jk, tk = jr.base_key(seed), tr.base_key(seed)
    yield jk, tk
    jk, tk = jr.sample_key(jk, 1_000_003), tr.sample_key(tk, 1_000_003)
    yield jk, tk
    jk, tk = jax.random.fold_in(jk, 37), tr.fold_in(tk, 37)
    yield jk, tk
    for stream in jr.Stream:
        yield (jr.bounce_key(jk, 3, stream),
               tr.bounce_key(tk, 3, tr.Stream(int(stream))))


def test_partitionable_threefry_is_on():
    """The port draws the bits of ``jax_threefry_partitionable=True``; a
    JAX whose default differs fails here first."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_bit_exact(seed):
    for jk, tk in _keys(seed):
        assert _key_words(jk) == tk


@pytest.mark.parametrize("shape", [(1001,), (257, 2), (129, 3)])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_uniform_bits_bit_exact(seed, shape):
    for jk, tk in list(_keys(seed))[2:5]:
        want = np.asarray(jax.random.bits(jk, shape))
        got = tr.random_bits(tk, shape, device="cpu").numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        want = np.asarray(jr.uniform(jk, shape))
        got = tr.uniform(tk, shape, device="cpu").numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert got.dtype == np.float32 and (0 <= got).all() \
            and (got < 1).all()


def test_normal_unit_vector_and_hemisphere_close():
    jk, tk = list(_keys(11))[-1]
    want = np.asarray(jax.random.normal(jk, (4000, 3)))
    got = tr.normal(tk, (4000, 3), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    want = np.asarray(jr.unit_vector(jk, (4000,)))
    got = tr.unit_vector(tk, (4000,), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    rng = np.random.default_rng(0)
    nrm = rng.normal(size=(4000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    want = np.asarray(jr.cosine_hemisphere(jk, nrm))
    got = tr.cosine_hemisphere(tk, torch.from_numpy(nrm)).numpy()
    np.testing.assert_allclose(got, want, atol=DIR_ATOL)
    np.testing.assert_array_equal(
        np.asarray(jr.uniform_box3(jk, (50,))),
        tr.uniform_box3(tk, (50,), device="cpu").numpy())


@pytest.mark.parametrize("lens,inclusive_uv,row_start,n_rows",
                         [(False, True, 0, None), (True, False, 3, 4)])
def test_generate_rays_matches_jax(lens, inclusive_uv, row_start, n_rows):
    w, h = 16, 8
    kw = dict(aperture=0.2, focus_dist=3.0) if lens else {}
    jcam = st.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                          aspect_ratio=w / h, **kw)
    cam = sp.camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam),
                               device="cpu")
    jk = jax.random.fold_in(jr.sample_key(jr.base_key(3), 5), row_start)
    tk = tr.fold_in(tr.sample_key(tr.base_key(3), 5), row_start)
    jo, jd = j_generate_rays(jcam, w, h, jk, inclusive_uv=inclusive_uv,
                             row_start=row_start, n_rows=n_rows)
    to, td = sp.generate_rays(cam, w, h, tk, inclusive_uv=inclusive_uv,
                              row_start=row_start, n_rows=n_rows)
    assert to.shape == jo.shape == (w * (n_rows or h), 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=DIR_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DIR_ATOL)


@pytest.mark.parametrize("model", ["physical", "reference"])
def test_scatter_matches_jax(model):
    """One key, 2000 hits on random materials (glass among them): the
    sampled directions and attenuations agree."""
    rng = np.random.default_rng(4)
    n = 2000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mat = dict(
        albedo=rng.uniform(0, 1, (n, 3)), emission=np.zeros((n, 3)),
        metallic=rng.choice([0.0, 0.5, 1.0], n),
        roughness=rng.uniform(0, 0.5, n), ior=rng.uniform(1.2, 1.8, n),
        transmission=rng.choice([0.0, 1.0], n), cauchy_b=np.zeros(n))
    mat = {k: v.astype(np.float32) for k, v in mat.items()}
    jk = jr.sample_key(jr.base_key(9), 2)
    tk = tr.sample_key(tr.base_key(9), 2)
    fn = dict(physical=(jbsdf.scatter_physical, tbsdf.scatter_physical),
              reference=(jbsdf.scatter_reference,
                         tbsdf.scatter_reference))[model]
    jdir, jatt = fn[0](jk, 2, d, nrm, mat)
    tdir, tatt = fn[1](tk, 2, torch.from_numpy(d), torch.from_numpy(nrm),
                       {k: torch.from_numpy(v) for k, v in mat.items()})
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir),
                               rtol=NORMAL_RTOL, atol=1e-5)
    np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))
