"""The PyTorch port's copied numpy helpers and config registry against the
JAX package's originals."""

import os
import subprocess
import sys

import numpy as np
import pytest

from opticalflow_ri_tpu import configs as jcfg
from opticalflow_ri_tpu.ops import gaussian as jgauss
from opticalflow_ri_tpu.ops import resize as jresize
from opticalflow_ri_tpu.utils import synthetic as jsynth

from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.ops import gaussian as tgauss
from opticalflow_ri_tpu_torch.ops import resize as tresize
from opticalflow_ri_tpu_torch.utils import synthetic as tsynth

HS_NAMES = ["PyHSchunck_Fs3_4", "PyHSchunck_Fs3_4_PyrLvls2", "HS_Fs0_0", "HS_Fs3_4",
            "HS_Fs3_4_PyrLvls2"]
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


def test_import_leaves_jax_out():
    code = ("import sys, opticalflow_ri_tpu_torch, opticalflow_ri_tpu_torch.configs, "
            "opticalflow_ri_tpu_torch.compile; assert 'jax' not in sys.modules, 'jax imported'")
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


def test_registry_covers_every_jax_config():
    assert set(tcfg.CONFIGS) == set(HS_NAMES)
    assert set(tcfg.CONFIGS) | set(tcfg.UNPORTED) == set(jcfg.CONFIGS)
    for name in tcfg.UNPORTED:
        with pytest.raises(KeyError, match="ROADMAP"):
            tcfg.run_config(name, None, None)
