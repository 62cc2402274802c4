"""The PyTorch port's padding, HS stencils and calibrated Gaussian against
the JAX package on the same seeded inputs (atol 1e-5)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu.ops import gaussian as jgauss
from opticalflow_ri_tpu.ops import padding as jpad
from opticalflow_ri_tpu.ops import stencil as jst

from opticalflow_ri_tpu_torch.ops import gaussian as tgauss
from opticalflow_ri_tpu_torch.ops import padding as tpad
from opticalflow_ri_tpu_torch.ops import stencil as tst

ATOL = 1e-5


def _img(shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["mirror", "symmetric", "nearest", "constant"])
@pytest.mark.parametrize("pad", [1, 3, ((0, 1), (0, 1)), ((2, 0), (1, 3))])
def test_pad2d_matches_jax(mode, pad):
    x = _img((47, 61))
    np.testing.assert_array_equal(tpad.pad2d(torch.from_numpy(x), pad, mode).numpy(),
                                  np.asarray(jpad.pad2d(jnp.asarray(x), pad, mode)))


@pytest.mark.parametrize("mode", ["mirror", "symmetric", "nearest"])
def test_pad2d_leading_dims_and_wide_pads(mode):
    x = _img((2, 3, 4, 5), seed=1)
    np.testing.assert_array_equal(tpad.pad2d(torch.from_numpy(x), 7, mode).numpy(),
                                  np.asarray(jpad.pad2d(jnp.asarray(x), 7, mode)))


def test_pad2d_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown border mode"):
        tpad.pad2d(torch.zeros(4, 4), 1, "wrap")


@pytest.mark.parametrize("shape", [(47, 61), (64, 128)])
def test_hs_derivatives_match_jax(shape):
    a, b = _img(shape, 1), _img(shape, 2)
    got = tst.hs_derivatives(torch.from_numpy(a), torch.from_numpy(b))
    want = jst.hs_derivatives(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["mirror", "nearest"])
def test_hs_avg3x3_matches_jax(mode):
    x = _img((47, 61), 3, -4.0, 4.0)
    np.testing.assert_allclose(tst.hs_avg3x3(torch.from_numpy(x), mode).numpy(),
                               np.asarray(jst.hs_avg3x3(jnp.asarray(x), mode)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(47, 61), (96, 96)])
def test_gaussian_filter_px_matches_jax(size, shape):
    x = _img(shape, 4)
    np.testing.assert_allclose(tgauss.gaussian_filter_px(torch.from_numpy(x), 3.4, size).numpy(),
                               np.asarray(jgauss.gaussian_filter_px(jnp.asarray(x), 3.4, size)),
                               rtol=0, atol=ATOL)


def test_gaussian_filter_truncate_matches_jax():
    x = _img((47, 61), 5, -1.0, 1.0)
    np.testing.assert_allclose(tgauss.gaussian_filter(torch.from_numpy(x), 1.8, 4.0).numpy(),
                               np.asarray(jgauss.gaussian_filter(jnp.asarray(x), 1.8, 4.0)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", ["mirror", "nearest", "constant"])
def test_correlate1d_matches_jax(axis, mode):
    x = _img((47, 61), 6)
    k = np.array([0.25, 0.0, 0.5, 0.125], np.float32)
    np.testing.assert_allclose(tst.correlate1d(torch.from_numpy(x), k, axis, mode).numpy(),
                               np.asarray(jst.correlate1d(jnp.asarray(x), k, axis, mode)),
                               rtol=0, atol=ATOL)
