"""The PyTorch port's warp and resize against the JAX package.

The plain version of the Hopper warp kernel is a 4-tap gather; it equals
the XLA tent contraction bit for bit and the Pallas tent kernels (summed
in another order) to 1e-5 relative.  The optical-flow-equation warp
(``liu_shen_warp``) is held to the bars of tests/test_liu_shen_warp.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu import pyramid as jpyr
from opticalflow_ri_tpu.models import horn_schunck as jhs
from opticalflow_ri_tpu.ops import resize as jresize
from opticalflow_ri_tpu.ops import warp as jwarp
from opticalflow_ri_tpu.ops.pallas.warp_tent import warp_pair_tent_pallas

from opticalflow_ri_tpu_torch import HSOpticalFlowAlgoAdapter, generic_pyramidal_optical_flow
from opticalflow_ri_tpu_torch.ops import resize as tresize
from opticalflow_ri_tpu_torch.ops import warp as twarp
from opticalflow_ri_tpu_torch.ops.cuda import warp_tent as tk
from conftest import aee

SHAPE = (48, 136)


def _pair_and_flows(seed, dmax):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, SHAPE).astype(np.float32)
    im2 = rng.uniform(0, 255, SHAPE).astype(np.float32)
    flows = [rng.uniform(-dmax, dmax, SHAPE).astype(np.float32) for _ in range(4)]
    return im1, im2, flows


@pytest.mark.parametrize("dmax", [2.5, 12.0])
def test_plain_warp_equals_xla_contraction(dmax):
    im1, _, (dy, dx, _, _) = _pair_and_flows(0, dmax)
    # exact integer displacements and both clamp bounds are edge cases of the taps
    dy[0, :4] = [-8.0, 8.0, 3.0, -0.0]
    dx[1, :4] = [7.999, -12.0, 0.0, -5.0]
    got = twarp.displacement_warp_tent(torch.from_numpy(im1), torch.from_numpy(dy),
                                       torch.from_numpy(dx)).numpy()
    want = np.asarray(jwarp.displacement_warp_tent(jnp.asarray(im1), jnp.asarray(dy),
                                                   jnp.asarray(dx)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dmax", [2.5, 12.0])
def test_plain_warp_pair_matches_pallas_interpret(sparse, dmax):
    im1, im2, (dy1, dx1, dy2, dx2) = _pair_and_flows(1, dmax)
    got = tk.warp_pair(*(torch.from_numpy(a) for a in (im1, im2, dy1, dx1, dy2, dx2)))
    want = warp_pair_tent_pallas(*(jnp.asarray(a) for a in (im1, im2, dy1, dx1, dy2, dx2)),
                                 interpret=True, sparse=sparse)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_warp_pair_cpu_is_two_plain_warps_without_counting():
    im1, im2, (dy1, dx1, dy2, dx2) = _pair_and_flows(2, 5.0)
    t = [torch.from_numpy(a) for a in (im1, im2, dy1, dx1, dy2, dx2)]
    before = tk.warp_pair.launches
    w1, w2 = tk.warp_pair(*t, max_shift=4)
    assert tk.warp_pair.launches == before
    assert torch.equal(w1, tk.displacement_warp_tent(t[0], t[2], t[3], 4))
    assert torch.equal(w2, tk.displacement_warp_tent(t[1], t[4], t[5], 4))


def test_bilinear_warp_rounded_matches_jax():
    im1, _, (dy, dx, _, _) = _pair_and_flows(3, 12.0)
    ys = np.arange(SHAPE[0], dtype=np.float32)[:, None] + dy
    xs = np.arange(SHAPE[1], dtype=np.float32)[None, :] + dx
    ys[0, :3] = [2.5, 3.5, -0.5]  # half-even rounding ties
    got = twarp.bilinear_warp_rounded(torch.from_numpy(im1), torch.from_numpy(ys),
                                      torch.from_numpy(xs)).numpy()
    want = np.asarray(jwarp.bilinear_warp_rounded(jnp.asarray(im1), jnp.asarray(ys),
                                                  jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("max_shift", [8, None])
def test_symmetric_warp_pair_matches_jax(max_shift):
    im1, im2, (u, v, _, _) = _pair_and_flows(4, 6.0)
    got = twarp.symmetric_warp_pair(torch.from_numpy(im1), torch.from_numpy(im2),
                                    torch.from_numpy(u), torch.from_numpy(v), max_shift)
    want = jwarp.symmetric_warp_pair(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u),
                                     jnp.asarray(v), max_shift)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("d,inside", [(5.5, True), (6.0, True), (7.99, True), (10.0, False)])
def test_tent_warp_clamp_envelope(d, inside):
    """Within R=8 the tent warp is the reference's unclamped rounded-bilinear
    warp; beyond it the displacement clamps to R - 1e-3."""
    img = torch.from_numpy(np.random.default_rng(7).uniform(0, 255, SHAPE).astype(np.float32))
    frac = torch.from_numpy(np.random.default_rng(8).uniform(-0.4, 0.4, SHAPE).astype(np.float32))
    dy = d - frac.abs()
    dx = -dy
    ys = torch.arange(SHAPE[0], dtype=torch.float32)[:, None] + dy
    xs = torch.arange(SHAPE[1], dtype=torch.float32)[None, :] + dx
    tent = twarp.displacement_warp_tent(img, dy, dx)
    exact = twarp.bilinear_warp_rounded(img, ys, xs)
    close = torch.allclose(tent, exact, rtol=0, atol=1e-5 * 255)
    assert close == inside


def _ls_warp_both(im, u, v):
    got = twarp.liu_shen_warp(torch.from_numpy(im), torch.from_numpy(u), torch.from_numpy(v))
    want = jwarp.liu_shen_warp(jnp.asarray(im), jnp.asarray(u), jnp.asarray(v))
    assert got.dtype == torch.float32 and got.shape == im.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", [(40, 48), (47, 61)])
def test_liu_shen_warp_subpixel_matches_jax(shape):
    """Sub-0.5 px flows: the integer scatter is the identity, isolating the
    intensity correction."""
    rng = np.random.default_rng(0)
    im = rng.uniform(0, 255, shape).astype(np.float32)
    u = rng.uniform(-0.4, 0.4, shape).astype(np.float32)
    v = rng.uniform(-0.4, 0.4, shape).astype(np.float32)
    got, want = _ls_warp_both(im, u, v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("dmax", [2, 5])
def test_liu_shen_warp_duplicate_destinations_match_jax(dmax):
    """Colliding integer shifts (negative wrap, high-end clip) resolve as the
    JAX scatter-max does: the last writer in row-major source order wins."""
    rng = np.random.default_rng(7)
    im = rng.uniform(0, 255, (32, 40)).astype(np.float32)
    u = rng.integers(-dmax, dmax + 1, im.shape).astype(np.float32)
    v = rng.integers(-dmax, dmax + 1, im.shape).astype(np.float32)
    h, w = im.shape
    ys, xs = np.mgrid[:h, :w]
    dst = (np.clip(ys + v.astype(np.int64), 0, h - 1) * w
           + np.clip(xs + u.astype(np.int64), 0, w - 1))
    assert len(np.unique(dst)) < dst.size  # the case has collisions
    got, want = _ls_warp_both(im, u, v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_liu_shen_warp_driver_matches_jax(piv_pair_small):
    """biLinear=False through the driver (the optical-flow-equation warp)."""
    im1, im2, _, _ = piv_pair_small
    ju, jv = jpyr.generic_pyramidal_optical_flow(
        im1, im2, 2.0, jhs.HSOpticalFlowAlgoAdapter([21.0, 45.0], 20,
                                                    provideGenericPyramidalDefaults=False),
        2, 1, warping=True, biLinear=False)
    tu, tv = generic_pyramidal_optical_flow(
        im1, im2, 2.0, HSOpticalFlowAlgoAdapter([21.0, 45.0], 20,
                                                provideGenericPyramidalDefaults=False),
        2, 1, warping=True, biLinear=False, device="cpu")
    assert np.isfinite(tu.numpy()).all() and np.isfinite(tv.numpy()).all()
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= 5e-6


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("out_hw", [(24, 68), (23, 61), (96, 272)])
def test_pil_resize_matches_jax(method, out_hw):
    img = np.random.default_rng(5).uniform(0, 255, SHAPE).astype(np.float32)
    got = tresize.pil_resize(torch.from_numpy(img), out_hw, method).numpy()
    want = np.asarray(jresize.pil_resize(jnp.asarray(img), out_hw, method))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("in_hw", [(24, 68), (23, 61)])
def test_spline_upsample_matches_jax(in_hw):
    field = np.random.default_rng(6).uniform(-3, 3, in_hw).astype(np.float32)
    got = tresize.spline_upsample(torch.from_numpy(field), (48, 136)).numpy()
    want = np.asarray(jresize.spline_upsample(jnp.asarray(field), (48, 136)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
