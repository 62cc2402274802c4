"""The PyTorch port's Farneback solver against the JAX package on the CPU:
the polynomial expansion, blurs, flow solve and M assembly (equal), the
plain updateMatrices against the XLA one (dense tent contraction and exact
gather), the plain kernels against the six Farneback Pallas kernels in
interpret mode at those kernels' own bars, ``farneback_solve`` against the
XLA solve (the Farneback flow bar, 6.7e-6), the adapter, and the wrappers'
dispatch (CPU tensors take the plain versions, uncounted)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu.models import farneback as jfb
from opticalflow_ri_tpu.ops.pallas.blur5_flow import blur5_flow_banded_pallas, blur5_flow_pallas
from opticalflow_ri_tpu.ops.pallas.fb_fused2 import fb_fused2_pallas
from opticalflow_ri_tpu.ops.pallas.tent_sample import (
    update_matrices_channel_pallas, update_matrices_pallas, update_matrices_sparse_pallas,
)
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch.models import farneback as tfb
from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow, fb_fused, tent_sample

FB_BAR = 6.7e-6      # ROADMAP / PARITY.md Farneback flow bar
M_BAR = 1e-6         # update_matrices, relative to max|M|: expected equal
SHAPES = [(64, 128), (47, 61)]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, shape).astype(np.float32) for _ in range(2)]


def _expansions(shape, seed):
    """R0, R1 of a random pair, from the JAX package's expansion (numpy)."""
    return [np.asarray(jfb.poly_expansion(jnp.asarray(im), 7, 1.5, impl="vpu"))
            for im in _images(shape, seed)]


def _flows(shape, kind, seed=1):
    """Calibrated (|d| <= 4), wild (|d| <= 20, past the clamp) or smooth
    PIV-like flows."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        yy = np.arange(shape[0], dtype=np.float32)[:, None] * np.ones((1, shape[1]), np.float32)
        return (2.0 * np.sin(yy / 20.0)).astype(np.float32), (1.5 * np.cos(yy / 30.0)).astype(
            np.float32)
    dmax = {"calibrated": 4.0, "wild": 20.0, "random5": 5.0, "random8": 8.0}[kind]
    return tuple(rng.uniform(-dmax, dmax, shape).astype(np.float32) for _ in range(2))


def _particle_m(shape, seed=7):
    """M of a particle pair at a smooth flow: the 2x2 solve is well conditioned."""
    im1, im2, _, _ = particle_image_pair(shape=shape, seed=seed)
    r0, r1 = (tfb.poly_expansion(_t(im), 7, 1.5) for im in (im1, im2))
    fx, fy = (_t(f) for f in _flows(shape, "smooth"))
    return tent_sample.update_matrices_plain(fx, fy, r0, r1).numpy()


# ------------------------------------------------------------- plain helpers

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,sigma", [(7, 1.5), (5, 1.1), (9, 2.0)])
def test_poly_expansion_matches_jax(shape, n, sigma):
    im = _images(shape, 0)[0]
    want = np.asarray(jfb.poly_expansion(jnp.asarray(im), n, sigma, impl="vpu"))
    got = tfb.poly_expansion(_t(im), n, sigma)
    assert got.shape == (5, *shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_blurs_match_jax(shape):
    im = _images(shape, 2)[0]
    m = _expansions(shape, 3)[0]
    for smooth, sigma in ((3, 0.0), (3, 0.5), (5, 1.5)):
        np.testing.assert_array_equal(tfb.gaussian_blur(_t(im), smooth, sigma).numpy(),
                                      np.asarray(jfb.gaussian_blur(jnp.asarray(im), smooth, sigma)))
    np.testing.assert_array_equal(tfb.gaussian_blur5(_t(m), 33, 33 / 2 * 0.3).numpy(),
                                  np.asarray(jfb.gaussian_blur5(jnp.asarray(m), 33, 33 / 2 * 0.3)))
    np.testing.assert_array_equal(tfb.box_filter5(_t(m), 16).numpy(),
                                  np.asarray(jfb.box_filter5(jnp.asarray(m), 16)))


def test_update_flow_matches_jax():
    """On the M of a random pair.  XLA on the CPU flushes subnormal products
    to zero and PyTorch keeps them, so a particle pair's dark background
    (M ~ 1e-20, products below 1e-38) would differ by ~1e-35 there."""
    shape = (64, 128)
    r0, r1 = (_t(a) for a in _expansions(shape, 3))
    fx, fy = (_t(f) for f in _flows(shape, "calibrated"))
    m = tent_sample.update_matrices_plain(fx, fy, r0, r1).numpy()
    for got, want in zip(tfb.update_flow(_t(m)), jfb.update_flow(jnp.asarray(m))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("row0,img_rows", [(0, None), (17, 100)])
def test_assemble_m_matches_jax(row0, img_rows):
    shape = (47, 61)
    r0, s = _expansions(shape, 4)
    fx, fy = _flows(shape, "calibrated")
    inside = np.random.default_rng(5).uniform(size=shape) > 0.3
    got = tfb.assemble_m(_t(s), _t(r0), _t(fx), _t(fy), torch.from_numpy(inside), row0, img_rows)
    want = jfb.assemble_m(jnp.asarray(s), jnp.asarray(r0), jnp.asarray(fx), jnp.asarray(fy),
                          jnp.asarray(inside), row0, img_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["calibrated", "wild"])
@pytest.mark.parametrize("R", [5, None], ids=["R5", "gather"])
def test_update_matrices_plain_matches_jax(shape, kind, R):
    r0, r1 = _expansions(shape, 6)
    fx, fy = _flows(shape, kind)
    want = np.asarray(jfb.update_matrices(jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(r0),
                                          jnp.asarray(r1), R))
    got = tent_sample.update_matrices_plain(_t(fx), _t(fy), _t(r0), _t(r1), R).numpy()
    scale = float(np.abs(want).max())
    print(f"{shape} {kind} R={R}: max|d|/max|M| {np.abs(got - want).max() / scale!r}")
    np.testing.assert_allclose(got, want, rtol=0, atol=M_BAR * scale)


# ------------------------------------------- plain versions against Pallas kernels

def _um_inputs(kind):
    shape = (64, 128)
    r0, r1 = _expansions(shape, 2)
    fx, fy = _flows(shape, kind, seed=8)
    return (r0, r1, fx, fy), tent_sample.update_matrices_plain(_t(fx), _t(fy), _t(r0), _t(r1))


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
@pytest.mark.parametrize("kind", ["random5", "smooth", "random8"])
def test_update_matrices_plain_matches_pallas_interpret(kernel, kind):
    """The whole-field kernels: the dense one at its bar against XLA
    (atol 1e-6 x max|M|, rtol 1e-5), the sparse one at its bar against the
    dense one (2e-5 x max|M|, rtol 1e-3)."""
    (r0, r1, fx, fy), plain = _um_inputs(kind)
    fn = update_matrices_pallas if kernel == "dense" else update_matrices_sparse_pallas
    pal = np.asarray(fn(*(jnp.asarray(a) for a in (fx, fy, r0, r1)), interpret=True))
    scale = float(np.abs(pal).max())
    atol, rtol = (1e-6, 1e-5) if kernel == "dense" else (2e-5, 1e-3)
    np.testing.assert_allclose(plain.numpy(), pal, atol=atol * scale, rtol=rtol)


@pytest.mark.parametrize("sparse", [False, True, "2d"], ids=["dense", "sparse", "sparse2d"])
def test_update_matrices_plain_matches_channel_pallas_interpret(sparse):
    """The channel-blocked sampler + XLA assembly: the dense body at its bar
    against XLA (2e-6 x max|M|, rtol 1e-4), the sparse bodies at theirs
    against it (2e-5 x max|M|, rtol 1e-3)."""
    (r0, r1, fx, fy), plain = _um_inputs("random5")
    pal = np.asarray(update_matrices_channel_pallas(
        *(jnp.asarray(a) for a in (fx, fy, r0, r1)), interpret=True, sparse=sparse))
    scale = float(np.abs(pal).max())
    atol, rtol = (2e-6, 1e-4) if sparse is False else (2e-5, 1e-3)
    np.testing.assert_allclose(plain.numpy(), pal, atol=atol * scale, rtol=rtol)


@pytest.mark.parametrize("use_gaussian", [True, False], ids=["gaussian", "box"])
@pytest.mark.parametrize("kernel", ["whole", "banded"])
def test_blur5_flow_plain_matches_pallas_interpret(use_gaussian, kernel):
    """Both blur + solve kernels (the banded one at band 8) at the bar of the
    JAX package's blur5 tests (flow within 1e-4)."""
    m = _particle_m((64, 128))
    taps, mode, scale = tfb._window_blur_spec(33, use_gaussian)
    k = tuple(float(x) for x in taps)
    if kernel == "whole":
        pal = blur5_flow_pallas(jnp.asarray(m), k, mode, scale, interpret=True)
    else:
        pal = blur5_flow_banded_pallas(jnp.asarray(m), k, mode, scale, band=8, interpret=True)
    plain = blur5_flow.blur5_flow_plain(_t(m), taps, mode, scale)
    for got, want in zip(plain, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_gaussian", [True, False], ids=["gaussian", "box"])
def test_fb_fused_plain_matches_pallas_interpret(use_gaussian):
    """The whole loop (3 rounds from zero flow) against fb_fused2_pallas, whose
    fold-matrix blur reassociates the taps: rtol/atol 1e-4, its own bar."""
    shape = (64, 128)
    rng = np.random.default_rng(23)
    im1 = rng.uniform(0, 255, shape).astype(np.float32)
    im2 = (np.roll(im1, (1, 2), axis=(0, 1))
           + rng.normal(0, 2, shape).astype(np.float32)).astype(np.float32)
    r0, r1 = (np.asarray(jfb.poly_expansion(jnp.asarray(im), 7, 1.5, impl="vpu"))
              for im in (im1, im2))
    z = np.zeros(shape, np.float32)
    taps, mode, scale = tfb._window_blur_spec(33, use_gaussian)
    pal = fb_fused2_pallas(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(z), jnp.asarray(z), 3,
                           tuple(float(x) for x in taps), mode, scale, interpret=True)
    plain = fb_fused.fb_fused_plain(_t(r0), _t(r1), _t(z), _t(z), 3, taps, mode, scale)
    for got, want in zip(plain, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- the solve

@pytest.mark.parametrize("shape,kw", [
    ((96, 96), {}),
    ((47, 61), {}),
    ((96, 96), {"use_gaussian": False}),
    ((96, 96), {"pyr_levels": 2}),
], ids=["96x96", "47x61", "96x96-box", "96x96-2levels"])
def test_farneback_solve_matches_jax(shape, kw):
    im1, im2, _, _ = particle_image_pair(shape=shape, seed=3, max_disp=2.5)
    z = np.zeros(shape, np.float32)
    ju, jv = jfb.farneback_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z),
                                 jnp.asarray(z), impl="xla", **kw)
    tu, tv = tfb.farneback_solve(_t(im1), _t(im2), _t(z), _t(z), **kw)
    assert tu.shape == shape and tu.dtype == torch.float32 and tu.device.type == "cpu"
    d = max(float(np.abs(tu.numpy() - np.asarray(ju)).max()),
            float(np.abs(tv.numpy() - np.asarray(jv)).max()))
    print(f"{shape} {kw}: max|d| {d!r} (bar {FB_BAR})")
    assert d <= FB_BAR


def test_fb_fused_is_one_level_of_the_solve():
    """The fused loop from zero flow on the level-0 expansions is
    ``farneback_solve`` at one level (the entry tests/test_torch_cuda_kernels.py
    drives on the card)."""
    im1, im2, _, _ = particle_image_pair(shape=(64, 96), seed=4)
    z = torch.zeros((64, 96))
    want = tfb.farneback_solve(_t(im1), _t(im2), z, z)
    plan = tfb._level_plan(64, 96, 0.5, 0)[0]
    r0, r1 = (tfb.poly_expansion(tfb.gaussian_blur(_t(im), plan["smooth"], plan["sigma"]), 7, 1.5)
              for im in (im1, im2))
    taps, mode, scale = tfb._window_blur_spec(33, True)
    got = fb_fused.fb_fused(r0, r1, z, z, 5, taps, mode, scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_adapter_matches_jax():
    im1, im2, _, _ = particle_image_pair(shape=(64, 96), seed=5, max_disp=2.0)
    rng = np.random.default_rng(9)
    U, V = (rng.uniform(-0.5, 0.5, (64, 96)).astype(np.float32) for _ in range(2))
    ta = tfb.FarnebackAdapter(windowSize=15, Niters=3, polyN=5, polySigma=1.1, pyramidalLevels=2)
    ja = jfb.FarnebackAdapter(windowSize=15, Niters=3, polyN=5, polySigma=1.1, pyramidalLevels=2)
    tu, tv, terr = ta.compute(_t(im1), _t(im2), _t(U), _t(V))
    ju, jv, jerr = ja.compute(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(U), jnp.asarray(V))
    assert terr == jerr == "Unknown"
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) <= FB_BAR
    assert float(np.abs(tv.numpy() - np.asarray(jv)).max()) <= FB_BAR
    assert ta.getAlgoName() == ja.getAlgoName()
    assert ta.hasGenericPyramidalDefaults() and not tfb.FarnebackAdapter(
        provideGenericPyramidalDefaults=False).hasGenericPyramidalDefaults()
    assert ta.getGenericPyramidalDefaults() == ja.getGenericPyramidalDefaults() == {
        "warping": False, "scaling": True}


def test_adapter_constructor_checks():
    with pytest.raises(ValueError, match="odd"):
        tfb.FarnebackAdapter(windowSize=32)
    with pytest.raises(AssertionError):
        tfb.FarnebackAdapter(polyN=6)
    with pytest.raises(AssertionError):
        tfb.FarnebackAdapter(pyramidalLevels=0)


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sparse", "pallas_dense",
                                  "pallas_channel", "pallas_channel_sparse",
                                  "pallas_channel_sparse2d", "pallas_mmblur", "bogus"])
def test_tpu_impls_raise(impl):
    z = torch.zeros((40, 40))
    with pytest.raises(ValueError, match="impl"):
        tfb.farneback_solve(z, z, z, z, impl=impl)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    shape = (40, 56)
    r0, r1 = (_t(a) for a in _expansions(shape, 10))
    fx, fy = (_t(f) for f in _flows(shape, "calibrated"))
    taps, mode, scale = tfb._window_blur_spec(33, False)
    counters = (tent_sample.update_matrices, blur5_flow.blur5_flow, fb_fused.fb_fused)
    before = [c.launches for c in counters]
    m = tent_sample.update_matrices(fx, fy, r0, r1)
    assert torch.equal(m, tent_sample.update_matrices_plain(fx, fy, r0, r1))
    flow = blur5_flow.blur5_flow(m, taps, mode, scale)
    for g, w in zip(flow, blur5_flow.blur5_flow_plain(m, taps, mode, scale)):
        assert torch.equal(g, w)
    fused = fb_fused.fb_fused(r0, r1, fx, fy, 2, taps, mode, scale)
    for g, w in zip(fused, fb_fused.fb_fused_plain(r0, r1, fx, fy, 2, taps, mode, scale)):
        assert torch.equal(g, w)
    assert [c.launches for c in counters] == before


def test_non_cuda_devices_raise():
    meta = torch.device("meta")
    f = torch.empty((16, 24), device=meta)
    r = torch.empty((5, 16, 24), device=meta)
    taps, mode, scale = tfb._window_blur_spec(33, True)
    with pytest.raises(ValueError, match="CUDA"):
        tent_sample.update_matrices(f, f, r, r)
    with pytest.raises(ValueError, match="CUDA"):
        blur5_flow.blur5_flow(r, taps, mode, scale)
    with pytest.raises(ValueError, match="CUDA"):
        fb_fused.fb_fused(r, r, f, f, 5, taps, mode, scale)
