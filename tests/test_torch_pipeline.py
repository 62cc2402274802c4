"""The PyTorch port's HS pyramidal main path against the JAX package, end to
end on the CPU (AEE <= 5e-6, the whole-pipeline bar), plus the golden
regression of tests/test_golden.py."""

import os

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu import configs as jcfg
from opticalflow_ri_tpu import pyramid as jpyr
from opticalflow_ri_tpu.models import horn_schunck as jhs
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch import (
    GenericPyramidalOpticalFlowWrapper, HSOpticalFlowAlgoAdapter,
    generic_pyramidal_optical_flow,
)
from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.compile import compiled_pipeline
from conftest import aee

AEE_BAR = 5e-6
HS_NAMES = ["HS_Fs0_0", "HS_Fs3_4", "PyHSchunck_Fs3_4", "HS_Fs3_4_PyrLvls2",
            "PyHSchunck_Fs3_4_PyrLvls2"]
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


def test_compiled_pipeline_is_the_config(pair):
    im1, im2 = pair
    fn = compiled_pipeline("HS_Fs3_4_PyrLvls2")
    a = fn(im1, im2, device="cpu")
    b = tcfg.run_config("HS_Fs3_4_PyrLvls2", im1, im2, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tensor_inputs_keep_their_device_and_mismatch_raises(pair):
    im1, im2 = pair
    u, _ = tcfg.run_config("HS_Fs0_0", torch.from_numpy(im1), torch.from_numpy(im2))
    assert u.device.type == "cpu"  # the "cuda" default applies to numpy inputs only
    with pytest.raises(ValueError, match="different devices"):
        tcfg.run_config("HS_Fs0_0", torch.from_numpy(im1),
                        torch.from_numpy(im2).to("meta"))
