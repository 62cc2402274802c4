"""The PyTorch port's HS, Liu-Shen, dense-LK and Farneback pyramidal paths
against the JAX package, end to end on the CPU (AEE <= 5e-6, the
whole-pipeline bar; for LK also |d| <= 1.2e-4 on >= 99.9 % of pixels, for
Farneback |d| <= 6.7e-6 everywhere), plus the golden regressions of
tests/test_golden.py."""

import os

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu import configs as jcfg
from opticalflow_ri_tpu import pyramid as jpyr
from opticalflow_ri_tpu.models import horn_schunck as jhs
from opticalflow_ri_tpu.models import liu_shen as jls
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch import (
    GenericPyramidalOpticalFlowWrapper, HSOpticalFlowAlgoAdapter,
    LiuShenOpticalFlowAlgoAdapter, generic_pyramidal_optical_flow,
)
from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.models.farneback import FarnebackAdapter
from opticalflow_ri_tpu_torch.models.lucas_kanade import DenseLucasKanadeAdapter
from opticalflow_ri_tpu_torch.compile import compiled_pipeline
from conftest import aee

AEE_BAR = 5e-6
HS_NAMES = ["HS_Fs0_0", "HS_Fs3_4", "PyHSchunck_Fs3_4", "HS_Fs3_4_PyrLvls2",
            "PyHSchunck_Fs3_4_PyrLvls2"]
LS_NAMES = ["LiuSE_HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
            "LiuSE_LK_Fs2_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2"]
LK_NAMES = ["denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
            "LK_Fs2_0", "LK_Fs2_0_PyrLvls2"]
FB_NAMES = ["Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
            "FB_Fs0_0", "FB_Fs0_0_PyrLvls2"]
LK_BAR = 1.2e-4       # ROADMAP's LK bar on u, v
FB_BAR = 6.7e-6       # ROADMAP / PARITY.md Farneback flow bar on u, v
LK_BULK = 0.999       # LK's |delta| < 0.01 exit can flip on isolated pixels (test_golden.py:51)
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "synthetic96_flows.npz")


@pytest.fixture(scope="module", params=[(96, 96), (47, 61)], ids=["96x96", "47x61"])
def pair(request):
    im1, im2, _, _ = particle_image_pair(shape=request.param, seed=3, max_disp=2.5)
    return im1, im2


@pytest.mark.parametrize("name", HS_NAMES)
def test_hs_config_matches_jax(name, pair):
    im1, im2 = pair
    ju, jv = jcfg.run_config(name, im1, im2)
    tu, tv = tcfg.run_config(name, im1, im2, device="cpu")
    assert tu.dtype == torch.float32 and tu.shape == im1.shape and tu.device.type == "cpu"
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR


@pytest.mark.parametrize("name", LS_NAMES)
def test_liu_shen_config_matches_jax(name, pair):
    im1, im2 = pair
    ju, jv = jcfg.run_config(name, im1, im2)
    tu, tv = tcfg.run_config(name, im1, im2, device="cpu")
    assert tu.dtype == torch.float32 and tu.shape == im1.shape and tu.device.type == "cpu"
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR


@pytest.mark.parametrize("name", LK_NAMES)
def test_lucas_kanade_config_matches_jax(name, pair):
    im1, im2 = pair
    ju, jv = jcfg.run_config(name, im1, im2)
    tu, tv = tcfg.run_config(name, im1, im2, device="cpu")
    assert tu.dtype == torch.float32 and tu.shape == im1.shape and tu.device.type == "cpu"
    ju, jv = np.asarray(ju), np.asarray(jv)
    assert aee(tu.numpy(), tv.numpy(), ju, jv) <= AEE_BAR
    within = (np.abs(tu.numpy() - ju) <= LK_BAR) & (np.abs(tv.numpy() - jv) <= LK_BAR)
    print(f"{name}: {int((~within).sum())} of {within.size} pixels outside {LK_BAR}")
    assert within.mean() >= LK_BULK


@pytest.mark.parametrize("name", FB_NAMES)
def test_farneback_config_matches_jax(name, pair):
    im1, im2 = pair
    ju, jv = jcfg.run_config(name, im1, im2)
    tu, tv = tcfg.run_config(name, im1, im2, device="cpu")
    assert tu.dtype == torch.float32 and tu.shape == im1.shape and tu.device.type == "cpu"
    ju, jv = np.asarray(ju), np.asarray(jv)
    assert aee(tu.numpy(), tv.numpy(), ju, jv) <= AEE_BAR
    d = max(float(np.abs(tu.numpy() - ju).max()), float(np.abs(tv.numpy() - jv).max()))
    print(f"{name}: max|d| {d!r} (bar {FB_BAR})")
    assert d <= FB_BAR


def test_wrapper_matches_jax(pair):
    im1, im2 = pair
    ju, jv = jpyr.GenericPyramidalOpticalFlowWrapper(
        jhs.HSOpticalFlowAlgoAdapter([21.0], 600), filter_sigma=3.4).calculateFlow(im1, im2)
    tu, tv = GenericPyramidalOpticalFlowWrapper(
        HSOpticalFlowAlgoAdapter([21.0], 600), filter_sigma=3.4,
        device="cpu").calculateFlow(im1, im2)
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR


def test_two_k_levels_match_jax(pair):
    """kLevels=2 re-warps at the same level (the k > 0 branch of the driver)."""
    im1, im2 = pair
    ju, jv = jpyr.generic_pyramidal_optical_flow(
        im1, im2, 3.4, jhs.HSOpticalFlowAlgoAdapter([21.0, 21.0, 45.0, 45.0], 40), 2, 2)
    tu, tv = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 21.0, 45.0, 45.0], 40), 2, 2,
        device="cpu")
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR


def test_hs_golden(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    golden = np.load(_GOLDEN)
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1, device="cpu")
    assert aee(u.numpy(), v.numpy(), golden["hs_u"], golden["hs_v"]) < 1e-3


def test_hs_liu_shen_golden(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    golden = np.load(_GOLDEN)
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 60), 2, 1,
        FILTER_OPT=0.48, optionalOFlowAlgoAdapter=LiuShenOpticalFlowAlgoAdapter(5),
        device="cpu")
    assert aee(u.numpy(), v.numpy(), golden["hs_ls_u"], golden["hs_ls_v"]) < 1e-3


def test_lk_golden(piv_pair_small):
    """The bulk check of tests/test_golden.py:45-54."""
    im1, im2, _, _ = piv_pair_small
    golden = np.load(_GOLDEN)
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 2.0, DenseLucasKanadeAdapter(), 2, 1, FILTER_OPT=0.48, warping=False,
        device="cpu")
    du = np.abs(u.numpy() - golden["lk_u"])
    dv = np.abs(v.numpy() - golden["lk_v"])
    assert ((du < 1e-2) & (dv < 1e-2)).mean() > 0.99


def test_fb_golden(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    golden = np.load(_GOLDEN)
    u, v = generic_pyramidal_optical_flow(im1, im2, 0.0, FarnebackAdapter(), 2, 1, device="cpu")
    assert aee(u.numpy(), v.numpy(), golden["fb_u"], golden["fb_v"]) < 2e-3


def test_liu_shen_refiner_in_the_driver_matches_jax(pair):
    """The JAX golden call with LS(5) as the optional adapter, at 40 HS iterations."""
    im1, im2 = pair
    ju, jv = jpyr.generic_pyramidal_optical_flow(
        im1, im2, 3.4, jhs.HSOpticalFlowAlgoAdapter([21.0, 45.0], 40), 2, 1,
        FILTER_OPT=0.48, optionalOFlowAlgoAdapter=jls.LiuShenOpticalFlowAlgoAdapter(5))
    tu, tv = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 40), 2, 1,
        FILTER_OPT=0.48, optionalOFlowAlgoAdapter=LiuShenOpticalFlowAlgoAdapter(5),
        device="cpu")
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR


@pytest.mark.parametrize("name", ["HS_Fs3_4_PyrLvls2", "LiuSE_HS_Fs3_4_PyrLvls2"])
def test_compiled_pipeline_is_the_config(name, pair):
    im1, im2 = pair
    fn = compiled_pipeline(name)
    a = fn(im1, im2, device="cpu")
    b = tcfg.run_config(name, im1, im2, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tensor_inputs_keep_their_device_and_mismatch_raises(pair):
    im1, im2 = pair
    u, _ = tcfg.run_config("HS_Fs0_0", torch.from_numpy(im1), torch.from_numpy(im2))
    assert u.device.type == "cpu"  # the "cuda" default applies to numpy inputs only
    with pytest.raises(ValueError, match="different devices"):
        tcfg.run_config("HS_Fs0_0", torch.from_numpy(im1),
                        torch.from_numpy(im2).to("meta"))
