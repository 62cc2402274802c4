"""The PyTorch port's copied numpy helpers and config registry against the
JAX package's originals."""

import os
import subprocess
import sys

import numpy as np
import pytest

from opticalflow_ri_tpu import configs as jcfg
from opticalflow_ri_tpu.models import farneback as jfb
from opticalflow_ri_tpu.oracle import lucas_kanade as jlk_oracle
from opticalflow_ri_tpu.ops import gaussian as jgauss
from opticalflow_ri_tpu.ops import kernels_bitexact as jkb
from opticalflow_ri_tpu.ops import resize as jresize
from opticalflow_ri_tpu.ops import window_sums as jws
from opticalflow_ri_tpu.utils import synthetic as jsynth

from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.models import farneback as tfb
from opticalflow_ri_tpu_torch.models import lucas_kanade as tlk
from opticalflow_ri_tpu_torch.ops import gaussian as tgauss
from opticalflow_ri_tpu_torch.ops import kernels_bitexact as tkb
from opticalflow_ri_tpu_torch.ops import resize as tresize
from opticalflow_ri_tpu_torch.ops import window_sums as tws
from opticalflow_ri_tpu_torch.utils import synthetic as tsynth

HS_NAMES = ["PyHSchunck_Fs3_4", "PyHSchunck_Fs3_4_PyrLvls2", "HS_Fs0_0", "HS_Fs3_4",
            "HS_Fs3_4_PyrLvls2"]
LS_NAMES = ["LiuSE_HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
            "LiuSE_LK_Fs2_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2"]
LK_NAMES = ["denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
            "LK_Fs2_0", "LK_Fs2_0_PyrLvls2"]
FB_NAMES = ["Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
            "FB_Fs0_0", "FB_Fs0_0_PyrLvls2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sigma,size", [(3.4, 3), (3.4, 5), (0.48, 5), (1.8, 25), (2.0, 4)])
def test_prepare_gaussian_kernel_copy(sigma, size):
    np.testing.assert_array_equal(tgauss.prepare_gaussian_kernel(sigma, size),
                                  jgauss.prepare_gaussian_kernel(sigma, size))


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("in_size,out_size", [(96, 48), (47, 24), (61, 30), (48, 96), (24, 47)])
def test_pil_resize_matrix_copy(method, in_size, out_size):
    np.testing.assert_array_equal(tresize.pil_resize_matrix(in_size, out_size, method),
                                  jresize.pil_resize_matrix(in_size, out_size, method))


@pytest.mark.parametrize("in_size,out_size", [(48, 96), (24, 47), (30, 61)])
def test_spline_resize_matrix_copy(in_size, out_size):
    np.testing.assert_array_equal(tresize.spline_resize_matrix(in_size, out_size),
                                  jresize.spline_resize_matrix(in_size, out_size))


def test_hs_table_and_alphas_copy():
    assert tcfg.HS_H_TABLE == jcfg.HS_H_TABLE
    for bits, ni in jcfg.HS_H_TABLE:
        for levels in (1, 2, 3):
            for k in (1, 2):
                assert tcfg.hs_alphas(levels, k, bits, ni) == jcfg.hs_alphas(levels, k, bits, ni)


@pytest.mark.parametrize("shape,seed", [((96, 96), 3), ((47, 61), 0)])
def test_particle_image_pair_copy(shape, seed):
    for a, b in zip(tsynth.particle_image_pair(shape=shape, seed=seed),
                    jsynth.particle_image_pair(shape=shape, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("win", [7, 15, 16, 27, 31])
@pytest.mark.parametrize("near,far", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_window_mask_copy(win, near, far):
    np.testing.assert_array_equal(tlk.window_mask(win, near, far),
                                  jlk_oracle.window_mask(win, near, far))


@pytest.mark.parametrize("win", [7, 16, 27])
@pytest.mark.parametrize("near,far", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_runs_from_mask_copy(win, near, far):
    mask = jlk_oracle.window_mask(win, near, far)
    assert tws.runs_from_mask(mask) == jws.runs_from_mask(mask)


def test_smooth_factorization_copy():
    for length in range(1, 33):
        assert tws._smooth_factorization(length) == jws._smooth_factorization(length)


def _same_kernel(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype


@pytest.mark.parametrize("n", [3, 5, 7, 9])
@pytest.mark.parametrize("sigma", [0.0, -1.0])
def test_bitexact_fixed_kernels_copy(n, sigma):
    _same_kernel(tkb.get_gaussian_kernel_bit_exact(n, sigma),
                 jkb.get_gaussian_kernel_bit_exact(n, sigma))


@pytest.mark.parametrize("n", [3, 5, 9, 33])
def test_bitexact_positive_sigma_is_ignored_copy(n):
    """A positive sigma is replaced by n * 0.15 + 0.35 (kernels_bitexact.py:56-59):
    every positive sigma gives the same kernel, in both packages; a negative
    one is used as |sigma|."""
    first = tkb.get_gaussian_kernel_bit_exact(n, 0.5)
    for sigma in (0.5, 1.5, 4.95, -2.0):
        got = tkb.get_gaussian_kernel_bit_exact(n, sigma)
        _same_kernel(got, jkb.get_gaussian_kernel_bit_exact(n, sigma))
        if sigma > 0:
            _same_kernel(got, first)


def test_border_ramp_copy():
    np.testing.assert_array_equal(tfb.BORDER_RAMP, jfb.BORDER_RAMP)
    assert tfb.BORDER_RAMP.dtype == jfb.BORDER_RAMP.dtype


@pytest.mark.parametrize("n,sigma", [(5, 1.1), (5, 1.5), (7, 1.1), (7, 1.5)])
def test_prepare_poly_gaussian_copy(n, sigma):
    tg, txg, txxg, tconst = tfb.prepare_poly_gaussian(n, sigma)
    jg, jxg, jxxg, jconst = jfb.prepare_poly_gaussian(n, sigma)
    for a, b in zip((tg, txg, txxg), (jg, jxg, jxxg)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32
    assert tconst == jconst


@pytest.mark.parametrize("rows,cols", [(40, 40), (63, 100), (64, 64), (47, 61), (96, 96),
                                       (512, 333)])
def test_level_plan_copy(rows, cols):
    """Under 64 px a second level would be below the min size 32 and is cropped."""
    for levels in range(4):
        for pyr_scale in (0.5, 0.6):
            assert (tfb._level_plan(rows, cols, pyr_scale, levels)
                    == jfb._level_plan(rows, cols, pyr_scale, levels))


def test_import_leaves_jax_out():
    code = ("import sys, opticalflow_ri_tpu_torch, opticalflow_ri_tpu_torch.configs, "
            "opticalflow_ri_tpu_torch.compile, opticalflow_ri_tpu_torch.models.lucas_kanade, "
            "opticalflow_ri_tpu_torch.models.farneback, opticalflow_ri_tpu_torch.ops.cuda.fb_fused; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", HS_NAMES)
def test_hs_config_fields_match(name):
    jc, tc = jcfg.CONFIGS[name], tcfg.build_config(name)
    assert (tc.name, tc.filter_sigma, tc.pyr_levels, tc.k_levels, tc.filter_opt, tc.kwargs) == (
        jc.name, jc.filter_sigma, jc.pyr_levels, jc.k_levels, jc.filter_opt, jc.kwargs)
    assert tc.optional is None and jc.optional is None
    jm, tm = jc.main(), tc.main()
    assert (tm.alphas, tm.Niter, tm.getGenericPyramidalDefaults()) == (
        jm.alphas, jm.Niter, jm.getGenericPyramidalDefaults())


def _adapter_params(ad):
    """What a registered adapter carries: its class name, alphas or alpha,
    iteration count and pyramid defaults."""
    if ad is None:
        return None
    keys = ("alphas", "alpha", "Niter")
    params = {k: getattr(ad, k) for k in keys if hasattr(ad, k)}
    defaults = ad.getGenericPyramidalDefaults() if ad.hasGenericPyramidalDefaults() else None
    return type(ad).__name__, params, defaults


@pytest.mark.parametrize("name", LS_NAMES)
def test_liu_shen_config_fields_match(name):
    jc, tc = jcfg.CONFIGS[name], tcfg.build_config(name)
    assert (tc.name, tc.filter_sigma, tc.pyr_levels, tc.k_levels, tc.filter_opt, tc.kwargs) == (
        jc.name, jc.filter_sigma, jc.pyr_levels, jc.k_levels, jc.filter_opt, jc.kwargs)
    assert _adapter_params(tc.main()) == _adapter_params(jc.main())
    opt = (lambda c: c.optional() if c.optional is not None else None)
    assert _adapter_params(opt(tc)) == _adapter_params(opt(jc))


@pytest.mark.parametrize("name", LK_NAMES)
def test_lucas_kanade_config_fields_match(name):
    jc, tc = jcfg.CONFIGS[name], tcfg.build_config(name)
    assert (tc.name, tc.filter_sigma, tc.pyr_levels, tc.k_levels, tc.filter_opt, tc.kwargs) == (
        jc.name, jc.filter_sigma, jc.pyr_levels, jc.k_levels, jc.filter_opt, jc.kwargs)
    jm, tm = jc.main(), tc.main()
    keys = ("Niter", "halfWindow", "max_shift", "enableVorticityEnhancement",
            "computeErrorMap", "provideGenericPyramidalDefaults")
    assert {k: getattr(tm, k) for k in keys} == {k: getattr(jm, k) for k in keys}
    assert tm.getGenericPyramidalDefaults() == jm.getGenericPyramidalDefaults()
    opt = (lambda c: c.optional() if c.optional is not None else None)
    assert _adapter_params(opt(tc)) == _adapter_params(opt(jc))


FB_KEYS = ("windowSize", "numIters", "polyN", "polySigma", "useGaussianFilter", "pyrScale",
           "pyramidalLevels", "provideGenericPyramidalDefaults")


@pytest.mark.parametrize("name", FB_NAMES)
def test_farneback_config_fields_match(name):
    jc, tc = jcfg.CONFIGS[name], tcfg.build_config(name)
    assert (tc.name, tc.filter_sigma, tc.pyr_levels, tc.k_levels, tc.filter_opt, tc.kwargs) == (
        jc.name, jc.filter_sigma, jc.pyr_levels, jc.k_levels, jc.filter_opt, jc.kwargs)
    jm, tm = jc.main(), tc.main()
    assert type(tm).__name__ == type(jm).__name__ == "FarnebackAdapter"
    assert {k: getattr(tm, k) for k in FB_KEYS} == {k: getattr(jm, k) for k in FB_KEYS}
    assert tm.getGenericPyramidalDefaults() == jm.getGenericPyramidalDefaults()
    opt = (lambda c: c.optional() if c.optional is not None else None)
    assert _adapter_params(opt(tc)) == _adapter_params(opt(jc))


def test_registry_covers_every_jax_config():
    assert tcfg.UNPORTED == {}
    assert set(tcfg.CONFIGS) == set(HS_NAMES) | set(LS_NAMES) | set(LK_NAMES) | set(FB_NAMES)
    assert set(tcfg.CONFIGS) == set(jcfg.CONFIGS)
    with pytest.raises(KeyError, match="unknown config"):
        tcfg.run_config("Farneback_Fs9_9", None, None)
