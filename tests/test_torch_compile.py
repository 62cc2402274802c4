"""The port's ``compile`` module on the CPU: ``scan_pipeline`` against the JAX
package's ``scan_pipeline`` (AEE <= 5e-6, the whole-pipeline bar) and bit
for bit against per-pair ``run_config``; one pipeline object per config;
and the CPU-side proof that a run is capturable in a CUDA graph: after one
run at a shape, a second run copies no constant from the host, and the
driver formats no device tensor while a capture is under way."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_ri_tpu.compile import scan_pipeline as jax_scan_pipeline
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.compile import compiled_pipeline, pipeline_fn, scan_pipeline
from opticalflow_ri_tpu_torch.models import lucas_kanade as tlk
from opticalflow_ri_tpu_torch.utils import device as tdevice
from conftest import aee

AEE_BAR = 5e-6


def _stack(shape, seeds):
    pairs = [particle_image_pair(shape=shape, seed=s, max_disp=2.5)[:2] for s in seeds]
    return (np.stack([p[0] for p in pairs]).astype(np.float32),
            np.stack([p[1] for p in pairs]).astype(np.float32))


@pytest.mark.parametrize("name", ["HS_Fs0_0", "LiuSE_HS_Fs3_4_PyrLvls2"])
def test_scan_matches_jax_scan(name):
    im1s, im2s = _stack((48, 48), (0, 1, 2))
    ju, jv = jax_scan_pipeline(name)(jnp.asarray(im1s), jnp.asarray(im2s))
    tu, tv = scan_pipeline(name)(im1s, im2s, device="cpu")
    assert tu.shape == (3, 48, 48) and tu.dtype == torch.float32 and tu.device.type == "cpu"
    for k in range(3):
        assert aee(tu[k].numpy(), tv[k].numpy(), np.asarray(ju[k]), np.asarray(jv[k])) <= AEE_BAR


@pytest.mark.parametrize("name", ["HS_Fs3_4", "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0",
                                  "FB_Fs0_0"])
def test_scan_equals_per_pair_run_config(name):
    im1s, im2s = _stack((47, 61), (4, 5))
    us, vs = scan_pipeline(name)(im1s, im2s, device="cpu")
    for k in range(2):
        u, v = tcfg.run_config(name, im1s[k], im2s[k], device="cpu")
        assert torch.equal(us[k], u) and torch.equal(vs[k], v)
    # CPU tensors stay on the CPU whatever the device argument says
    ut, _ = scan_pipeline(name)(torch.from_numpy(im1s), torch.from_numpy(im2s))
    assert ut.device.type == "cpu" and torch.equal(ut, us)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_cpu_scan_stages_nothing(as_tensor):
    """The CPU runs the eager path pair by pair: no staging slot is made and
    the counters stay where they were."""
    im1s, im2s = _stack((40, 44), (12, 13))
    if as_tensor:
        im1s, im2s = torch.from_numpy(im1s), torch.from_numpy(im2s)
    scan = scan_pipeline("HS_Fs0_0")
    before = scan.staged, scan.overlapped
    us, vs = scan(im1s, im2s, device="cpu")
    assert (scan.staged, scan.overlapped) == before
    assert compiled_pipeline("HS_Fs0_0")._slots == {}
    for k in range(2):
        u, v = tcfg.run_config("HS_Fs0_0", im1s[k], im2s[k], device="cpu")
        assert torch.equal(us[k], u) and torch.equal(vs[k], v)


def test_pipelines_are_cached_per_name():
    assert compiled_pipeline("HS_Fs3_4") is compiled_pipeline("HS_Fs3_4")
    assert scan_pipeline("HS_Fs3_4") is scan_pipeline("HS_Fs3_4")
    assert compiled_pipeline("HS_Fs3_4") is not compiled_pipeline("HS_Fs0_0")
    with pytest.raises(KeyError):
        compiled_pipeline("no_such_config")


def test_compiled_pipeline_on_cpu_is_eager_and_fresh():
    im1s, im2s = _stack((40, 44), (6,))
    fn = compiled_pipeline("HS_Fs0_0")
    a = fn(im1s[0], im2s[0], device="cpu")
    b = fn(im1s[0], im2s[0], device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0] is not b[0]
    assert all(torch.equal(x, y)
               for x, y in zip(a, pipeline_fn("HS_Fs0_0")(im1s[0], im2s[0], device="cpu")))
    with pytest.raises(ValueError, match="CUDA graph"):
        fn.replay(im1s[0], im2s[0], device="cpu")
    fn.release()  # nothing captured: a no-op on the CPU


def test_shapes_are_checked():
    im1s, im2s = _stack((40, 44), (7, 8))
    with pytest.raises(ValueError, match="3-d"):
        scan_pipeline("HS_Fs0_0")(im1s, im2s[:, :, :40], device="cpu")
    with pytest.raises(ValueError, match="3-d"):
        scan_pipeline("HS_Fs0_0")(im1s[0], im2s[0], device="cpu")


NO_COPY_NAMES = ["HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "LK_Fs2_0_PyrLvls2",
                 "Farneback_Fs0_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2"]


@pytest.mark.parametrize("name", NO_COPY_NAMES)
def test_second_run_copies_no_constant(name, monkeypatch):
    """After one run at a shape every pad index, resize matrix and ramp is
    on the device: the next run makes no host-to-device copy, which a CUDA
    graph capture could not hold."""
    im1s, im2s = _stack((45, 58), (9,))
    tcfg.run_config(name, im1s[0], im2s[0], device="cpu")
    calls = []
    real = tdevice.host_to
    monkeypatch.setattr(tdevice, "host_to", lambda a, d: calls.append(a.shape) or real(a, d))
    tcfg.run_config(name, im1s[0], im2s[0], device="cpu")
    assert calls == []
    w = 40 + NO_COPY_NAMES.index(name)  # a shape no other case has run
    tcfg.run_config(name, im1s[0][:, :w], im2s[0][:, :w], device="cpu")
    assert calls


def test_error_map_weights_are_cached_and_unchanged(monkeypatch):
    """The LK error map's weights come from the constant cache and equal the
    mask product the map used before."""
    win = 27
    for asym in [(0, 0, 0, 0), (1, 0, 0, 1)]:
        wx, wy, _, _ = tlk._window_runs(13, asym)
        sym = tlk.window_mask(win, 0, 0)
        want = torch.from_numpy((sym[:, None] * sym[None, :]) * (wy[:, None] * wx[None, :]))
        got = tdevice.device_constant(tlk._error_weights, 13, asym, device="cpu")
        assert torch.equal(got, want)
    im1s, im2s = _stack((40, 44), (10,))
    a, b = torch.from_numpy(im1s[0]), torch.from_numpy(im2s[0])
    z = torch.zeros_like(a)
    first = tlk.lk_dense_solve(a, b, z, z, calc_err=True)
    calls = []
    monkeypatch.setattr(tdevice, "host_to", lambda arr, d: calls.append(arr.shape))
    second = tlk.lk_dense_solve(a, b, z, z, calc_err=True)
    assert calls == [] and all(torch.equal(x, y) for x, y in zip(first, second))


def _capture_reported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def test_error_logging_skipped_while_capturing(monkeypatch, caplog):
    im1s, im2s = _stack((40, 44), (11,))
    caplog.set_level(logging.INFO, logger="opticalflow_ri_tpu_torch")
    tcfg.run_config("LiuSE_HS_Fs3_4_PyrLvls2", im1s[0], im2s[0], device="cpu")
    assert "estimated error" in caplog.text  # outside a capture the error is logged
    caplog.clear()
    _capture_reported(monkeypatch)
    assert tdevice.capturing()
    tcfg.run_config("LiuSE_HS_Fs3_4_PyrLvls2", im1s[0], im2s[0], device="cpu")
    assert "estimated error" not in caplog.text
    assert "Level=1" in caplog.text  # the driver still logs what needs no device read


def test_capture_guards(monkeypatch):
    """The host-side reads that a capture forbids raise inside one."""
    u = torch.zeros((8, 8))
    assert tlk.evaluate_vorticity_asym(u, u, True) == (0, 0, 0, 0)
    _capture_reported(monkeypatch)
    with pytest.raises(RuntimeError, match="capture"):
        tlk.evaluate_vorticity_asym(u, u, True)
    assert tlk.evaluate_vorticity_asym(u, u, False) == (0, 0, 0, 0)
