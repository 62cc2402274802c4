"""The ``lk_ls_1024.stream`` cell at a CPU test's size: a sound run reads
``correct`` traced and untraced, the control and planted faults do not, and
the two LK rooflines read their stages on a hand-made trace, nothing where
the stage is absent, against the work counted by hand."""

import json
import os
import subprocess
import sys

import pytest
import torch

from opticalflow_ri_tpu_torch import compile as pipelines
from opticalflow_ri_tpu_torch import configs
from opticalflow_ri_tpu_torch.models import liu_shen, lucas_kanade
from pivbench import calibrate, lk_work, spec
from pivbench.drive import Window
from pivbench.harness import context, trace_faults
from pivbench.tests._cells import CHECKOUT, rehearse, small_cell
from pivbench.trace import DeviceOp, Trace

CELL = "lk_ls_1024.stream"
BW, PEAK = 3.35e12, 67e12


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


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    r = rehearse(small_cell(CELL, size=64), trace=trace)
    assert r["correct"], r["checks"]
    assert r["checks"]["pairs_compared"]["value"] == 4
    assert r["checks"]["flow_aee_px"]["value"] == 0.0         # the reference sums in the port's order
    if not trace:
        assert sorted(r["metrics"]) == ["pairs_per_s", "setup_s"]


def test_control_is_not_correct():
    cell = small_cell(CELL, size=64)
    n = calibrate.control_numbers(cell, 2**31 + 17, torch.device("cpu"))
    limits = cell.config["limits"]
    assert any(n[k] > limits[k] for k in limits), n


def _unchanged(self, im1, im2, U, V):
    return U, V, True


@pytest.mark.parametrize("adapter", [lucas_kanade.DenseLucasKanadeAdapter,
                                     liu_shen.LiuShenOpticalFlowAlgoAdapter])
def test_solver_returning_its_state_is_not_correct(adapter, monkeypatch):
    monkeypatch.setattr(adapter, "compute", _unchanged)
    r = rehearse(small_cell(CELL, size=64))
    assert not r["correct"] and r["failed"] > 0


def test_half_a_stack_left_out_is_not_correct(monkeypatch):
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
    assert not rehearse(small_cell(CELL, size=64, stack=2))["correct"]


def test_one_value_altered_is_not_correct(monkeypatch):
    real = configs.FlowConfig.run

    def altered(self, im1, im2, device="cuda"):
        u, v = real(self, im1, im2, device=device)
        v = v.clone()
        v[v.shape[0] // 2, v.shape[1] // 3] += 0.01
        return u, v

    monkeypatch.setattr(configs.FlowConfig, "run", altered)
    r = rehearse(small_cell(CELL, size=64))
    assert not r["correct"]
    assert r["checks"]["flow_max_px"]["value"] > r["checks"]["flow_max_px"]["limit"]


def test_lk_work_by_hand():
    build_b, build_ops = lk_work.lk_build(1024, 1024)
    assert build_b == 4 * (1065 * 1065 + 2 * 1055 * 1055 + 242 * 1024 * 1024)
    assert build_ops == 242 * 13 * 1024 * 1024
    assert build_b / BW == pytest.approx(0.3070e-3, rel=1e-3)       # bound by its bytes
    assert lk_work.lk_iterate(512, 512, 3.5) == (76 * 512 * 512, 60 * 3.5 * 512 * 512)
    assert lk_work.lk_iterate(512, 512, 0.0) == (44 * 512 * 512, 0.0)
    entries = [{"stage": "lk_iterate", "shape": (512, 512), "count": 3.5},
               {"stage": "lk_build", "shape": (512, 512), "count": 1},
               {"stage": "ls_iterate", "shape": (512, 512), "count": 60}]
    assert lk_work.stage_least_seconds("lk_iterate", entries) == pytest.approx(
        76 * 512 * 512 / BW, rel=1e-12)


def _ctx(with_lk=True):
    """A window of 1000 ns with one pair in one call: K6 200 ns, K7 50 ns,
    a Liu-Shen block, the copies, an entry and a fetch span."""
    ops = [DeviceOp("Memcpy HtoD (Pinned -> Device)", "htod", 100, 150),
           DeviceOp("(anonymous namespace)::ls_block_kernel(LsFields)", "kernel", 500, 600),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", "dtoh", 700, 800)]
    if with_lk:
        ops += [DeviceOp("(anonymous namespace)::lk_build_kernel(float const*)", "kernel",
                         150, 350),
                DeviceOp("void (anonymous namespace)::lk_gn_kernel<false>(GnParams)", "kernel",
                         350, 400)]
    ops.sort(key=lambda o: o.start)
    tr = Trace(ops, [("loop", 0, 1000), ("entry", 0, 100), ("fetch", 600, 900)])
    w = Window(0.0, 1.0, pairs=1, visits={0: 1}, event_ms=800 / 1e6)
    plain = Window(0.0, 0.5e-6, pairs=1, entry_s=100e-9)
    tally = {0: [{"stage": "lk_build", "shape": (512, 512), "count": 1},
                 {"stage": "lk_iterate", "shape": (512, 512), "count": 3.5},
                 {"stage": "ls_iterate", "shape": (512, 512), "count": 60}]}
    cell = spec.load_cell(CELL, CHECKOUT / "BENCHMARK.json")
    return cell, context(cell, tr, w, tally, plain)


def test_lk_rooflines_on_a_hand_made_trace():
    cell, ctx = _ctx()
    build = lk_work.work.least_seconds(*lk_work.lk_build(512, 512))
    assert spec.reader("lk_build_roofline")(ctx) == pytest.approx(100 * build / 200e-9)
    gn = 76 * 512 * 512 / BW
    assert spec.reader("lk_iterate_roofline")(ctx) == pytest.approx(100 * gn / 50e-9)
    readings = {m["name"]: v for m in cell.per_layer
                if (v := spec.reader(m["name"])(ctx)) is not None}
    assert {"lk_build_roofline", "lk_iterate_roofline", "pair_mfu"} <= readings.keys()
    assert "ls_iterate_roofline" not in readings          # not a metric of this cell
    assert trace_faults(cell, ctx, readings) == []


def test_lk_rooflines_read_nothing_without_their_kernels():
    cell, ctx = _ctx(with_lk=False)
    assert spec.reader("lk_build_roofline")(ctx) is None
    assert spec.reader("lk_iterate_roofline")(ctx) is None
    faults = trace_faults(cell, ctx, {})
    assert any("stage lk_build" in f for f in faults), faults
    assert any("lk_iterate_roofline found nothing" in f for f in faults), faults


REFERENCE = """
import json, sys
import torch
from pivbench.reference import pipeline
a = torch.rand(2, 48, 48) * 255
recipe = json.load(open("pivbench/configs/lk_ls_1024.json"))["pipeline"]
pipeline(a, a.roll(1, -1), recipe)
print(json.dumps(sorted(sys.modules)))
"""


def test_the_lk_reference_loads_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", REFERENCE], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pivbench.reference.lucas_kanade" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib")
                or m.split(".")[0].startswith("opticalflow_ri_tpu")]


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    """The control on three seeds at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's size on the card")
    cell = spec.load_cell(CELL, CHECKOUT / "BENCHMARK.json")
    limits = cell.config["limits"]
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        n = calibrate.control_numbers(cell, seed, torch.device("cuda"))
        assert any(n[k] > limits[k] for k in limits), (seed, n)
