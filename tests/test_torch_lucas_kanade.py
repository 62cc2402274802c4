"""The PyTorch port's dense Lucas-Kanade against the JAX package on the CPU:
the window sums (all three orders), the solve fields, the shift-plane build
(against the XLA build and the TPU build kernel in Pallas interpret mode),
the GN loop and the fused build+GN (against their TPU kernels in interpret
mode), ``lk_dense_solve`` against the XLA solve (the ROADMAP's LK bar, u and
v within 1.2e-4 and status equal), the GetError map, the vorticity window
choice and the adapter."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu.models import lucas_kanade as jlk
from opticalflow_ri_tpu.ops import window_sums as jws
from opticalflow_ri_tpu.ops.pallas.lk_build import lk_build_planes_pallas
from opticalflow_ri_tpu.ops.pallas.lk_iter import lk_fused_pallas, lk_gn_iterate_pallas

from opticalflow_ri_tpu_torch.models import lucas_kanade as tlk
from opticalflow_ri_tpu_torch.ops import window_sums as tws
from opticalflow_ri_tpu_torch.ops.cuda import lk_build, lk_iter
from opticalflow_ri_tpu_torch.ops.padding import pad2d

LK_BAR = 1.2e-4    # ROADMAP's LK bar on u, v (JAX's XLA solve sums its 121 lanes in another order)
FIELD_RTOL = 1e-6  # elementwise adds in the same order: expected equal
HW, R = 13, 5
RUNS = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, 0, 0))        # one run of 27
RUNS_NEAR = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, 1, 0))   # runs of 8 and 18
RUNS_FAR = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, 0, 1))    # one run of 26


def _pair(shape, seed, shift=(1, 2), noise=2.0):
    """A random frame and its rolled, noisy copy."""
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, shape).astype(np.float32)
    im2 = (np.roll(im1, shift, axis=(0, 1))
           + rng.normal(0, noise, shape).astype(np.float32)).astype(np.float32)
    return im1, im2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _fields(im1, im2, asym=(0, 0, 0, 0)):
    """The solve fields of both packages for one pair."""
    h, w = im1.shape
    runs_x = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, asym[0], asym[1]))
    runs_y = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, asym[2], asym[3]))
    pad = HW + (32 - HW) + R + 1
    jf = jlk.lk_solve_fields(jnp.pad(jnp.asarray(im1), pad, mode="edge"),
                             jnp.pad(jnp.asarray(im2), pad, mode="edge"),
                             HW, R, runs_y, runs_x, h, w)
    tf = tlk.lk_solve_fields(pad2d(_t(im1), pad, "nearest"), pad2d(_t(im2), pad, "nearest"),
                             HW, R, runs_y, runs_x, h, w)
    return jf, tf, runs_y, runs_x


def _gn_inputs(jf, u0, v0):
    """(ia11, ia12, ia22, c1, c2, act0, px0, py0) as torch tensors from the JAX fields."""
    _, _, ia11, ia12, ia22, c1, c2, ok = jf
    h, w = ok.shape
    jj = np.arange(w, dtype=np.float32)[None, :] + np.zeros((h, 1), np.float32)
    ii = np.arange(h, dtype=np.float32)[:, None] + np.zeros((1, w), np.float32)
    px0 = (jj + u0 - HW).astype(np.float32)
    py0 = (ii + v0 - HW).astype(np.float32)
    return (*(_t(f) for f in (ia11, ia12, ia22, c1, c2)),
            _t(np.asarray(ok).astype(np.float32)), _t(px0), _t(py0))


def _flow_init(shape, seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, shape).astype(np.float32),
            rng.uniform(-scale, scale, shape).astype(np.float32))


# ------------------------------------------------------------- window sums

@pytest.mark.parametrize("mode", [False, True, "ladder"], ids=["direct", "two-level", "ladder"])
@pytest.mark.parametrize("runs_y,runs_x", [(RUNS, RUNS), (RUNS_FAR, RUNS_NEAR), (RUNS_NEAR, RUNS_FAR)],
                         ids=["sym", "far-near", "near-far"])
def test_wsum2d_matches_jax(mode, runs_y, runs_x):
    """Elementwise slices and adds in the JAX order: equal (bar rtol 1e-6)."""
    x = np.random.default_rng(0).normal(0, 50, (2, 23 + 31, 41 + 31)).astype(np.float32)
    got = tws.wsum2d(_t(x), runs_y, runs_x, HW, 23, 41, mode).numpy()
    want = np.asarray(jws.wsum2d(jnp.asarray(x), runs_y, runs_x, HW, 23, 41, mode))
    assert got.shape == (2, 23, 41)
    np.testing.assert_allclose(got, want, rtol=FIELD_RTOL, atol=0)


@pytest.mark.parametrize("L", [1, 2, 7, 8, 18, 26, 27, 32])
@pytest.mark.parametrize("axis", [0, 1])
def test_ladder_run_matches_jax(L, axis):
    x = np.random.default_rng(L).normal(0, 1, (40, 45)).astype(np.float32)
    lo, out_len = 32 - L, 45 - 31 if axis == 1 else 40 - 31
    got = tws._ladder_run(_t(x), lo, L, x.shape[axis], axis, out_len).numpy()
    want = np.asarray(jws._ladder_run(jnp.asarray(x), lo, L, x.shape[axis], axis, out_len))
    np.testing.assert_allclose(got, want, rtol=FIELD_RTOL, atol=0)


# ------------------------------------------------------------ solve fields

@pytest.mark.parametrize("shape,asym", [((64, 128), (0, 0, 0, 0)), ((47, 61), (1, 0, 0, 1))],
                         ids=["64x128", "47x61-asym"])
def test_solve_fields_match_jax(shape, asym):
    im1, im2 = _pair(shape, 1)
    jf, tf, _, _ = _fields(im1, im2, asym)
    names = ("g_pair", "slab", "ia11", "ia12", "ia22", "c1", "c2")
    for name, t, j in zip(names, tf[:7], jf[:7]):
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=FIELD_RTOL,
                                   atol=FIELD_RTOL * scale, err_msg=name)
    np.testing.assert_array_equal(tf[7].numpy(), np.asarray(jf[7]))


# ------------------------------------------------------------------- build

def _build_inputs(shape, seed):
    """The build's inputs as the JAX kernel test makes them: a padded image
    slab and a random gradient pair."""
    h, w = shape
    rng = np.random.default_rng(seed)
    pad = HW + (32 - HW) + R + 1
    im = rng.uniform(0, 255, (h, w)).astype(np.float32)
    jpad = np.pad(im, pad, mode="edge")
    oi = pad - HW
    slab = np.ascontiguousarray(jpad[oi - R : oi - R + h + 31 + 2 * R,
                                     oi - R : oi - R + w + 31 + 2 * R])
    gp = rng.normal(0, 50, (2, h + 31, w + 31)).astype(np.float32)
    return slab, gp


BUILD_CASES = [((64, 128), RUNS, RUNS), ((72, 200), RUNS, RUNS_NEAR)]
BUILD_IDS = ["64x128-sym", "72x200-asym"]


@pytest.mark.parametrize("shape,runs_y,runs_x", BUILD_CASES, ids=BUILD_IDS)
@pytest.mark.parametrize("mode", [True, "ladder"], ids=["two-level", "ladder"])
def test_build_matches_jax_xla_build(shape, runs_y, runs_x, mode):
    h, w = shape
    slab, gp = _build_inputs(shape, 7)
    t1, t2 = tlk.lk_build_planes(_t(slab), _t(gp), runs_y, runs_x, HW, h, w, R, mode)
    j1, j2 = jlk.lk_build_planes(jnp.asarray(slab), jnp.asarray(gp), runs_y, runs_x, HW,
                                 h, w, R, hierarchical=mode)
    assert t1.shape == (121, h, w) and t2.shape == (121, h, w)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("shape,runs_y,runs_x", BUILD_CASES, ids=BUILD_IDS)
def test_build_matches_tpu_build_kernel_interpret(shape, runs_y, runs_x):
    """Kernel 6's plain version against the TPU build kernel (ladder mode),
    run in Pallas interpret mode: bit-identical."""
    slab, gp = _build_inputs(shape, 8)
    t1, t2 = lk_build.lk_build_planes(_t(slab), _t(gp), HW, R, runs_y, runs_x)
    j1, j2 = lk_build_planes_pallas(jnp.asarray(slab), jnp.asarray(gp), HW, R, runs_y, runs_x,
                                    mode="ladder", interpret=True)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_run_table_encodes_runs():
    table = list(lk_build.run_table(RUNS_NEAR))
    assert table[0] == 2
    assert table[1:10] == [0, 8, 3, 3, 2, 2, 2, 0, 0]     # L=8: ladder 2,2,2; base 3
    assert table[10:19] == [9, 18, 4, 3, 2, 3, 3, 0, 0]   # L=18: ladder 2,3,3; base 4
    assert list(lk_build.run_table(RUNS))[1:10] == [0, 27, 5, 3, 3, 3, 3, 0, 0]
    with pytest.raises(ValueError):
        lk_build.run_table(((0, 5),) * 5)
    with pytest.raises(ValueError):
        lk_build.run_table(((20, 40),))


# ------------------------------------------------------------------ GN loop

@pytest.mark.parametrize("init", [0.0, 2.5], ids=["zero-init", "random-init"])
def test_gn_matches_tpu_gn_kernel_interpret(init):
    """Kernel 7's plain version against the TPU GN kernel in interpret mode,
    on the same planes and fields (bar 1.2e-4 on the window origins; the
    separable order is the TPU kernel's, so they are expected equal)."""
    shape = (64, 128)
    im1, im2 = _pair(shape, 3)
    jf, _, _, _ = _fields(im1, im2)
    u0, v0 = _flow_init(shape, 4, init)
    t1, t2 = jlk.lk_build_planes(jf[1], jf[0], RUNS, RUNS, HW, *shape, R, hierarchical="ladder")
    args = _gn_inputs(jf, u0, v0)
    got = lk_iter.lk_gn_iterate(_t(t1), _t(t2), *args, 5, R, HW)
    want = lk_gn_iterate_pallas(t1, t2, *(jnp.asarray(a.numpy()) for a in args), 5, R, HW,
                                interpret=True)
    for g, w_, name in zip(got, want, ("px", "py")):
        assert float(np.abs(g.numpy() - np.asarray(w_)).max()) <= LK_BAR, name
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("shape,asym,init", [((64, 128), (0, 0, 0, 0), 0.0),
                                             ((32, 128), (1, 0, 0, 1), 1.5)],
                         ids=["64x128", "32x128-asym-init"])
def test_fused_matches_tpu_fused_kernel_interpret(shape, asym, init):
    """Kernel 8's plain version (two-level build + GN) against the TPU fused
    kernel in interpret mode (bar 1.2e-4 on the window origins, status equal)."""
    im1, im2 = _pair(shape, 5)
    jf, _, runs_y, runs_x = _fields(im1, im2, asym)
    u0, v0 = _flow_init(shape, 6, init)
    args = _gn_inputs(jf, u0, v0)
    got = lk_iter.lk_fused(_t(jf[1]), _t(jf[0]), *args, 5, R, HW, runs_y, runs_x)
    want = lk_fused_pallas(jf[1], jf[0], *(jnp.asarray(a.numpy()) for a in args), 5, R, HW,
                           runs_y, runs_x, interpret=True)
    for g, w_, name in zip(got, want, ("px", "py")):
        assert float(np.abs(g.numpy() - np.asarray(w_)).max()) <= LK_BAR, name
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _dense_gn(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0, n_iter):
    """The TPU GN kernel's loop (``lk_iter.py:74-119``) in float32 numpy: the
    tent weight of every one of the 121 shifts, contracted over sy and then
    over sx, ascending, from 0."""
    n = 2 * R + 1
    h, w = ia11.shape
    jj = np.arange(w, dtype=np.float32)[None, :]
    ii = np.arange(h, dtype=np.float32)[:, None]
    hi = np.float32(R - 1e-3)
    px, py, active = px0, py0, act0
    status = np.ones((h, w), np.float32)
    for _ in range(n_iter):
        oob = ((px < -HW) | (px >= w) | (py < -HW) | (py >= h)).astype(np.float32)
        status = status * (np.float32(1) - active * oob)
        active = active * (np.float32(1) - oob)
        uc = np.clip(px + np.float32(HW) - jj, np.float32(-R), hi)
        vc = np.clip(py + np.float32(HW) - ii, np.float32(-R), hi)
        wys = [np.maximum(np.float32(0), np.float32(1) - np.abs(vc - np.float32(sy - R)))
               for sy in range(n)]
        s1 = np.zeros((h, w), np.float32)
        s2 = np.zeros((h, w), np.float32)
        for sx in range(n):
            wx = np.maximum(np.float32(0), np.float32(1) - np.abs(uc - np.float32(sx - R)))
            ty1 = np.zeros((h, w), np.float32)
            ty2 = np.zeros((h, w), np.float32)
            for sy in range(n):
                ty1 = ty1 + wys[sy] * t1[sy * n + sx]
                ty2 = ty2 + wys[sy] * t2[sy * n + sx]
            s1 = s1 + wx * ty1
            s2 = s2 + wx * ty2
        b1, b2 = s1 - c1, s2 - c2
        dx = (ia12 * b2 - ia22 * b1) * np.float32(32)
        dy = (ia12 * b1 - ia11 * b2) * np.float32(32)
        px = px + dx * active
        py = py + dy * active
        small = ((np.abs(dx) < np.float32(0.01)) & (np.abs(dy) < np.float32(0.01)))
        active = active * (np.float32(1) - small.astype(np.float32))
    return px, py, status


@pytest.mark.parametrize("n_iter", [0, 1, 5])
@pytest.mark.parametrize("scale", [4.0, 20.0], ids=["calibrated", "wild"])
def test_gn_plain_equals_the_dense_tent_contraction(n_iter, scale):
    """The 4-tap blend adds exactly the non-zero terms of the TPU kernel's
    dense 121-shift contraction, in its order: equal bit for bit, also for
    flows past the R clamp and the out-of-bounds bail (|d| <= 20)."""
    shape = (40, 56)
    im1, im2 = _pair(shape, 9)
    jf, _, _, _ = _fields(im1, im2)
    u0, v0 = _flow_init(shape, 10, scale)
    t1, t2 = jlk.lk_build_planes(jf[1], jf[0], RUNS, RUNS, HW, *shape, R, hierarchical="ladder")
    args = _gn_inputs(jf, u0, v0)
    got = lk_iter.lk_gn_iterate_plain(_t(t1), _t(t2), *args, n_iter, R, HW)
    want = _dense_gn(np.asarray(t1), np.asarray(t2), *(a.numpy() for a in args), n_iter)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    if n_iter == 5 and scale == 20.0:
        assert float(got[2].min()) == 0.0  # some windows left the image


# -------------------------------------------------------------- whole solve

SOLVE_CASES = [((64, 128), (0, 0, 0, 0), 0.0), ((64, 128), (0, 0, 0, 0), 1.5),
               ((64, 128), (0, 1, 0, 1), 0.0), ((60, 130), (0, 0, 0, 0), 0.7),
               ((60, 130), (1, 0, 0, 1), 0.0)]
SOLVE_IDS = ["zero-init", "random-init", "asym-0101", "60x130-init", "60x130-asym-1001"]


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("shape,asym,init", SOLVE_CASES, ids=SOLVE_IDS)
def test_lk_dense_solve_matches_jax_xla(shape, asym, init, impl):
    im1, im2 = _pair(shape, 11)
    u0, v0 = _flow_init(shape, 12, init)
    ju, jv, js = jlk.lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u0),
                                    jnp.asarray(v0), asym=asym, impl="xla")
    tu, tv, ts = tlk.lk_dense_solve(_t(im1), _t(im2), _t(u0), _t(v0), asym=asym, impl=impl)
    assert tu.dtype == torch.float32 and tu.shape == shape
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) <= LK_BAR
    assert float(np.abs(tv.numpy() - np.asarray(jv)).max()) <= LK_BAR
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_singular_windows_keep_the_input_flow():
    """A flat patch has a singular structure tensor: flow kept, status 0."""
    shape = (48, 96)
    im1, im2 = _pair(shape, 13)
    im1[:, :40] = 7.0
    im2[:, :40] = 7.0
    u0, v0 = _flow_init(shape, 14, 0.5)
    tu, tv, ts = tlk.lk_dense_solve(_t(im1), _t(im2), _t(u0), _t(v0))
    ju, jv, js = jlk.lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u0),
                                    jnp.asarray(v0), impl="xla")
    assert float(ts[:, :10].max()) == 0.0
    np.testing.assert_array_equal(tu[:, :10].numpy(), u0[:, :10])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) <= LK_BAR


@pytest.mark.parametrize("shape", [(64, 128), (40, 56)])
def test_error_map_matches_jax(shape):
    """The GetError SAD map: the same gathers; the weighted window sum is an
    einsum whose order differs, so rtol 1e-5 relative to the map's scale."""
    im1, im2 = _pair(shape, 15)
    z = np.zeros(shape, np.float32)
    j = jlk.lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z),
                           impl="xla", calc_err=True)
    t = tlk.lk_dense_solve(_t(im1), _t(im2), _t(z), _t(z), calc_err=True)
    assert len(t) == 4
    scale = float(np.abs(np.asarray(j[3])).max())
    assert scale > 0
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-5, atol=1e-5 * scale)
    assert float(np.abs(t[0].numpy() - np.asarray(j[0])).max()) <= LK_BAR


# ----------------------------------------------------------- adapter, impl

@pytest.mark.parametrize("omega", [0.0, 0.01, -0.01])
def test_evaluate_vorticity_asym_matches_jax(omega):
    h, w = 40, 50
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (-omega * yy).astype(np.float32)
    v = (omega * xx).astype(np.float32)
    for enable in (False, True):
        assert tlk.evaluate_vorticity_asym(_t(u), _t(v), enable) == jlk.evaluate_vorticity_asym(
            jnp.asarray(u), jnp.asarray(v), enable)


def test_adapter_with_vorticity_matches_jax():
    shape = (64, 128)
    im1, im2 = _pair(shape, 16)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    U = (0.01 * yy).astype(np.float32)   # a rotation: an asymmetric window
    V = (-0.01 * xx).astype(np.float32)
    asym = jlk.evaluate_vorticity_asym(jnp.asarray(U), jnp.asarray(V), True)
    assert asym != (0, 0, 0, 0)
    assert tlk.evaluate_vorticity_asym(_t(U), _t(V), True) == asym
    ta = tlk.DenseLucasKanadeAdapter(enableVorticityEnhancement=True, computeErrorMap=True)
    ja = jlk.DenseLucasKanadeAdapter(enableVorticityEnhancement=True, computeErrorMap=True)
    tu, tv, terr = ta.compute(_t(im1), _t(im2), _t(U), _t(V))
    ju, jv, jerr = ja.compute(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(U), jnp.asarray(V))
    assert terr is True and jerr is True
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) <= LK_BAR
    assert float(np.abs(tv.numpy() - np.asarray(jv)).max()) <= LK_BAR
    assert ta.lastErrorMap is not None and ta.lastErrorMap.shape == shape
    assert ta.getGenericPyramidalDefaults() == ja.getGenericPyramidalDefaults()
    assert ta.hasGenericPyramidalDefaults() and (ta.Niter, ta.halfWindow, ta.max_shift) == (5, 13, 5)


@pytest.mark.parametrize("impl", ["xla", "pallas_build", "pallas_xlabuild", "pallas_striped",
                                  "bogus"])
def test_tpu_impls_raise(impl):
    z = torch.zeros((40, 40))
    with pytest.raises(ValueError, match="impl"):
        tlk.lk_dense_solve(z, z, z, z, impl=impl)
