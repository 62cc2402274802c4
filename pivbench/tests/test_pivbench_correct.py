"""``correct`` fails where it should: the control (the reference in the
precision below the configuration's in the program's place), and a run
whose timed path is broken underneath, once for each fault a cell can
have: a solver step that returns its state unchanged, half of a stack left
out, an answer altered where it is produced.  (The cells run on one card:
there is no exchange between cards to leave out.)  A sound run passes."""

import pytest
import torch

from opticalflow_ri_tpu_torch import compile as pipelines
from opticalflow_ri_tpu_torch import configs
from opticalflow_ri_tpu_torch.models import farneback, horn_schunck, liu_shen
from pivbench import calibrate, spec
from pivbench.tests._cells import CHECKOUT, rehearse, small_cell

CELLS = ["ls_hs_512.stream", "fb_2048.stream", "ls_hs_512.single", "fb_2048.single"]


@pytest.fixture(autouse=True)
def _fresh_pipelines():
    """One thread, and pipelines built anew in each test: a cached pipeline
    holds the run function it was built with."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    pipelines.compiled_pipeline.cache_clear()
    pipelines.scan_pipeline.cache_clear()
    yield
    pipelines.compiled_pipeline.cache_clear()
    pipelines.scan_pipeline.cache_clear()
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = rehearse(small_cell(name))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert r["checks"]["pairs_compared"]["value"] == 4        # every pair of the pool


@pytest.mark.parametrize("name", ["ls_hs_512.stream", "fb_2048.stream"])
def test_control_is_not_correct(name):
    cell = small_cell(name)
    n = calibrate.control_numbers(cell, 2**31 + 17, torch.device("cpu"))
    limits = cell.config["limits"]
    assert any(n[k] > limits[k] for k in limits), n


def _unchanged(self, im1, im2, U, V):
    return U, V, torch.zeros(())


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state_is_not_correct(name, monkeypatch):
    for adapter in (horn_schunck.HSOpticalFlowAlgoAdapter, liu_shen.LiuShenOpticalFlowAlgoAdapter,
                    farneback.FarnebackAdapter):
        monkeypatch.setattr(adapter, "compute", _unchanged)
    r = rehearse(small_cell(name))
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("name", ["ls_hs_512.stream", "fb_2048.stream"])
def test_half_a_stack_left_out_is_not_correct(name, monkeypatch):
    real = pipelines.scan_pipeline

    def half(registry):
        fn = real(registry)

        def scanned(im1s, im2s, device="cuda"):
            k = im1s.shape[0] // 2
            us, vs = fn(im1s[:k], im2s[:k], device)
            pad = torch.zeros_like(us)
            return torch.cat([us, pad]), torch.cat([vs, pad])
        scanned.release = fn.release
        return scanned

    monkeypatch.setattr(pipelines, "scan_pipeline", half)
    r = rehearse(small_cell(name, stack=2))
    assert not r["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced_is_not_correct(name, monkeypatch):
    real = configs.FlowConfig.run

    def altered(self, im1, im2, device="cuda"):
        u, v = real(self, im1, im2, device=device)
        return u + 1e-3, v

    monkeypatch.setattr(configs.FlowConfig, "run", altered)
    r = rehearse(small_cell(name))
    assert not r["correct"]
    assert r["checks"]["flow_aee_px"]["value"] > r["checks"]["flow_aee_px"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_one_value_altered_is_not_correct(name, monkeypatch):
    """Both configurations also compare the largest gap: one value off by
    0.05 px fails."""
    real = configs.FlowConfig.run

    def altered(self, im1, im2, device="cuda"):
        u, v = real(self, im1, im2, device=device)
        u = u.clone()
        u[u.shape[0] // 2, u.shape[1] // 3] += 0.05
        return u, v

    monkeypatch.setattr(configs.FlowConfig, "run", altered)
    r = rehearse(small_cell(name))
    assert not r["correct"]
    assert r["checks"]["flow_max_px"]["value"] > r["checks"]["flow_max_px"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ls_hs_512.stream", "fb_2048.stream"])
def test_control_fails_at_the_cells_size_on_the_card(name):
    """The control on three seeds at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's size on the card")
    cell = spec.load_cell(name, CHECKOUT / "BENCHMARK.json")
    limits = cell.config["limits"]
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        n = calibrate.control_numbers(cell, seed, torch.device("cuda"))
        assert any(n[k] > limits[k] for k in limits), (seed, n)
