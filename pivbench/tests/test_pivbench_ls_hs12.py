"""The ``ls_hs12_2560x2160.stream`` cell at a CPU test's size: 12-bit frames
through the calibrated name ``LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06``.
A sound run reads ``correct`` traced and untraced, on square and on
non-square frames; the control and a solver that returns its state do not;
``hs_blocked_roofline`` reads K1's stage on a hand-made trace with the
yardstick of ``hs_iterate_roofline``, and nothing where the stage is
absent."""

import pytest
import torch

from opticalflow_ri_tpu_torch import compile as pipelines
from opticalflow_ri_tpu_torch.models import horn_schunck, liu_shen
from pivbench import calibrate, spec
from pivbench.drive import Window
from pivbench.harness import context, trace_faults
from pivbench.tests._cells import CHECKOUT, rehearse, small_cell
from pivbench.trace import DeviceOp, Trace

CELL = "ls_hs12_2560x2160.stream"
PEAK = 67e12


@pytest.fixture(autouse=True)
def _fresh_pipelines():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    pipelines.compiled_pipeline.cache_clear()
    pipelines.scan_pipeline.cache_clear()
    yield
    pipelines.compiled_pipeline.cache_clear()
    pipelines.scan_pipeline.cache_clear()
    torch.set_num_threads(saved)


def _cell(shape=(48, 48)):
    cell = small_cell(CELL)
    cell.config.update(height=shape[0], width=shape[1])
    return cell


def test_the_cell_is_the_calibrated_pipeline():
    cfg = spec.load_cell(CELL, CHECKOUT / "BENCHMARK.json").config
    assert cfg["registry"] == "LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06"
    assert (cfg["height"], cfg["width"], cfg["bit_depth"]) == (2160, 2560, 12)
    assert cfg["pipeline"]["main"]["calibration"] == ["Bits12", "Ni06"]


@pytest.mark.parametrize("shape,trace", [((48, 48), False), ((48, 48), True),
                                         ((40, 64), False)])
def test_sound_run_is_correct(shape, trace):
    r = rehearse(_cell(shape), trace=trace)
    assert r["correct"], r["checks"]
    assert r["checks"]["pairs_compared"]["value"] == 4
    if not trace:
        assert sorted(r["metrics"]) == ["pairs_per_s", "setup_s"]


def test_control_is_not_correct():
    cell = _cell((40, 64))
    n = calibrate.control_numbers(cell, 2**31 + 17, torch.device("cpu"))
    limits = cell.config["limits"]
    assert any(n[k] > limits[k] for k in limits), n


def _unchanged(self, im1, im2, U, V):
    return U, V, torch.zeros(())


@pytest.mark.parametrize("adapter", [horn_schunck.HSOpticalFlowAlgoAdapter,
                                     liu_shen.LiuShenOpticalFlowAlgoAdapter])
def test_solver_returning_its_state_is_not_correct(adapter, monkeypatch):
    monkeypatch.setattr(adapter, "compute", _unchanged)
    r = rehearse(_cell((40, 64)))
    assert not r["correct"] and r["failed"] > 0


def _ctx(with_hs=True):
    """A window of 1000 ns with one pair in one call: K1 200 ns (two blocked
    launches), a Liu-Shen block, the copies, an entry and a fetch span."""
    ops = [DeviceOp("Memcpy HtoD (Pinned -> Device)", "htod", 100, 150),
           DeviceOp("(anonymous namespace)::ls_block_kernel(LsFields)", "kernel", 500, 600),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", "dtoh", 700, 800)]
    if with_hs:
        ops += [DeviceOp("(anonymous namespace)::hs_block_kernel(float const*)", "kernel",
                         150, 250),
                DeviceOp("(anonymous namespace)::hs_block_kernel(float const*)", "kernel",
                         250, 350)]
    ops.sort(key=lambda o: o.start)
    tr = Trace(ops, [("loop", 0, 1000), ("entry", 0, 100), ("fetch", 600, 900)])
    w = Window(0.0, 1.0, pairs=1, visits={0: 1}, event_ms=800 / 1e6)
    plain = Window(0.0, 0.5e-6, pairs=1, entry_s=100e-9)
    tally = {0: [{"stage": "hs_iterate", "shape": (1080, 1280), "count": 600},
                 {"stage": "ls_iterate", "shape": (1080, 1280), "count": 60},
                 {"stage": "hs_iterate", "shape": (2160, 2560), "count": 600},
                 {"stage": "ls_iterate", "shape": (2160, 2560), "count": 60}]}
    cell = spec.load_cell(CELL, CHECKOUT / "BENCHMARK.json")
    return cell, context(cell, tr, w, tally, plain)


def test_hs_blocked_roofline_on_a_hand_made_trace():
    cell, ctx = _ctx()
    # (27 * 600 + 5) operations a pixel at both levels: bound by operations
    least = 16205 * (1080 * 1280 + 2160 * 2560) / PEAK
    assert spec.reader("hs_blocked_roofline")(ctx) == pytest.approx(100 * least / 200e-9)
    assert spec.reader("hs_blocked_roofline")(ctx) == spec.reader("hs_iterate_roofline")(ctx)
    readings = {m["name"]: v for m in cell.per_layer
                if (v := spec.reader(m["name"])(ctx)) is not None}
    assert {"hs_blocked_roofline", "pair_mfu", "device_idle_share", "copy_ms"} <= \
        readings.keys()
    assert "hs_iterate_roofline" not in readings        # not a metric of this cell
    assert trace_faults(cell, ctx, readings) == []


def test_hs_blocked_roofline_reads_nothing_without_k1():
    cell, ctx = _ctx(with_hs=False)
    assert spec.reader("hs_blocked_roofline")(ctx) is None
    faults = trace_faults(cell, ctx, {})
    assert any("stage hs_iterate" in f for f in faults), faults
    assert any("hs_blocked_roofline found nothing" in f for f in faults), faults


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    """The control on three seeds at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's size on the card")
    cell = spec.load_cell(CELL, CHECKOUT / "BENCHMARK.json")
    limits = cell.config["limits"]
    for seed in (2**31 + 41, 2**31 + 42, 2**31 + 43):
        n = calibrate.control_numbers(cell, seed, torch.device("cuda"))
        assert all(n[k] > limits[k] for k in limits), (seed, n)
