"""The port's campaign harness on the CPU: the batch runner (the cases of
tests/test_batch_runner.py, its flows against the JAX runner's), the
benchmark grid's artefacts, the per-config and runner command lines, the
timing helpers and the environment report."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

from opticalflow_ri_tpu.harness.batch_runner import FlowBatchRunner as JaxRunner
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner, pairs_from_glob
from opticalflow_ri_tpu_torch.harness.benchmark import run_benchmark
from opticalflow_ri_tpu_torch.utils import envcheck, timing
from conftest import aee

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AEE_BAR = 5e-6


def _make_dataset(tmp_path, n=5, shape=(48, 48)):
    pairs = []
    for i in range(n):
        im1, im2, _, _ = particle_image_pair(shape=shape, seed=i)
        p1 = str(tmp_path / f"f{i}_0.tif")
        p2 = str(tmp_path / f"f{i}_1.tif")
        Image.fromarray(im1.astype(np.uint8)).save(p1)
        Image.fromarray(im2.astype(np.uint8)).save(p2)
        pairs.append((f"pair{i}", p1, p2))
    return pairs


def _flow(path):
    vel = scipy.io.loadmat(path)["velocities"]
    return vel["u"][0, 0], vel["v"][0, 0]


def _runner(config, out, **kw):
    return FlowBatchRunner(config, output_dir=out, device="cpu", **kw)


def test_runs_and_saves(tmp_path):
    pairs = _make_dataset(tmp_path)
    out = str(tmp_path / "out")
    state = _runner("HS_Fs0_0", out, batch_size=2).run(pairs)
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)
    assert state["failed"] == []
    assert state["batches"] == 3 and state["seconds_per_batch"] > 0
    assert {"compute_wait_s", "transfer_save_s"} <= state.keys()
    assert os.path.exists(os.path.join(out, "pair3.mat"))
    u, _ = _flow(os.path.join(out, "pair0.mat"))
    assert u.shape == (48, 48)
    # the ragged tail (pair4, padded to a batch of 2) keeps its own flow
    a = np.asarray(Image.open(pairs[4][1]), np.float32)
    b = np.asarray(Image.open(pairs[4][2]), np.float32)
    want = run_config("HS_Fs0_0", a, b, device="cpu")
    got = _flow(os.path.join(out, "pair4.mat"))
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


def test_resume_skips_done(tmp_path):
    pairs = _make_dataset(tmp_path, n=4)
    out = str(tmp_path / "out")
    runner = _runner("HS_Fs0_0", out, batch_size=2)
    runner.run(pairs[:2])
    with open(os.path.join(out, "progress.json")) as f:
        assert len(json.load(f)["done"]) == 2
    state = runner.run(pairs)  # resume: only the remaining 2 processed
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)
    assert state["batches"] == 1


def test_failure_isolation(tmp_path):
    pairs = _make_dataset(tmp_path, n=3)
    bad = ("badpair", str(tmp_path / "missing_0.tif"), str(tmp_path / "missing_1.tif"))
    out = str(tmp_path / "out")
    state = _runner("HS_Fs0_0", out, batch_size=1).run([pairs[0], bad, pairs[1], pairs[2]])
    assert state["failed"] == ["badpair"]
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)


def test_batched_pipeline_is_refused(tmp_path):
    """The JAX runner's vmapped pipeline is deprecated there and not ported."""
    assert _runner("HS_Fs0_0", str(tmp_path / "o")).pipeline == "scan"
    with pytest.raises(ValueError, match="deprecated"):
        _runner("HS_Fs0_0", str(tmp_path / "o"), pipeline="batched")
    with pytest.raises(ValueError, match="scan"):
        _runner("HS_Fs0_0", str(tmp_path / "o"), pipeline="vmap")


def test_config_mismatch_refused(tmp_path):
    pairs = _make_dataset(tmp_path, n=1)
    out = str(tmp_path / "out")
    _runner("HS_Fs0_0", out, batch_size=1).run(pairs)
    with pytest.raises(ValueError, match="belongs to config"):
        _runner("HS_Fs3_4", out, batch_size=1).run(pairs)


@pytest.mark.parametrize("name", ["HS_Fs0_0", "LiuSE_HS_Fs3_4_PyrLvls2"])
def test_runner_flows_match_jax_runner(tmp_path, name):
    pairs = _make_dataset(tmp_path, n=3)
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    st_t = _runner(name, out_t, batch_size=2).run(pairs)
    st_j = JaxRunner(name, batch_size=2, output_dir=out_j).run(pairs)
    assert sorted(st_t["done"]) == sorted(st_j["done"]) == sorted(p[0] for p in pairs)
    for pname, _, _ in pairs:
        tu, tv = _flow(os.path.join(out_t, f"{pname}.mat"))
        ju, jv = _flow(os.path.join(out_j, f"{pname}.mat"))
        assert aee(tu, tv, ju, jv) <= AEE_BAR


def test_pairs_from_glob(tmp_path):
    pairs = _make_dataset(tmp_path, n=3)
    got = pairs_from_glob(str(tmp_path / "*_0.tif"), str(tmp_path / "*_1.tif"))
    assert [(p0, p1) for _, p0, p1 in got] == [(p[1], p[2]) for p in pairs]
    assert [n for n, _, _ in got] == ["f0_0", "f1_0", "f2_0"]
    with pytest.raises(ValueError, match="mismatch"):
        pairs_from_glob(str(tmp_path / "*_0.tif"), str(tmp_path / "f0_1.tif"))


def test_run_benchmark_artifacts(tmp_path):
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=11)
    out = str(tmp_path / "bench")
    results = run_benchmark(im1, im2, output_dir=out, configs=["no_such_config", "HS_Fs0_0"],
                            plots=False, device="cpu")
    assert list(results) == ["HS_Fs0_0"]  # the unknown config fails alone
    r = results["HS_Fs0_0"]
    assert r["U"].shape == (64, 64) and np.isfinite(r["U"]).all() and r["time"] > 0
    want = run_config("HS_Fs0_0", im1, im2, device="cpu")
    assert np.array_equal(r["U"], want[0].numpy())
    m = scipy.io.loadmat(os.path.join(out, "HS_Fs0_0.mat"))
    assert "velocities" in m and "parameters" in m
    assert not os.path.exists(os.path.join(out, "HS_Fs0_0.png"))
    with open(os.path.join(out, "benchmark_summary.txt")) as f:
        summary = f.read()
    assert "HS_Fs0_0" in summary and "Time (s)" in summary


def test_run_benchmark_plots_need_matplotlib(tmp_path, monkeypatch):
    im1, im2, _, _ = particle_image_pair(shape=(32, 32), seed=12)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(RuntimeError, match="matplotlib"):
        run_benchmark(im1, im2, output_dir=str(tmp_path / "b"), configs=["HS_Fs0_0"],
                      plots=True, device="cpu")


def _cli(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(tmp_path))


def test_run_config_cli(tmp_path):
    pairs = _make_dataset(tmp_path, n=1, shape=(40, 52))
    out = tmp_path / "flow.mat"
    proc = _cli(["opticalflow_ri_tpu_torch.harness.run_config", "LK_Fs2_0", "--im1",
                 pairs[0][1], "--im2", pairs[0][2], "--out", str(out), "--device", "cpu"],
                tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "jax" not in proc.stderr.lower()
    a = np.asarray(Image.open(pairs[0][1]), np.float32)
    b = np.asarray(Image.open(pairs[0][2]), np.float32)
    want = run_config("LK_Fs2_0", a, b, device="cpu")
    got = _flow(str(out))
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    bad = _cli(["opticalflow_ri_tpu_torch.harness.run_config", "no_such_config"], tmp_path)
    assert bad.returncode != 0


def test_batch_runner_cli(tmp_path):
    _make_dataset(tmp_path, n=3, shape=(32, 32))
    proc = _cli(["opticalflow_ri_tpu_torch.harness.batch_runner", "--config", "HS_Fs0_0",
                 "--glob0", str(tmp_path / "*_0.tif"), "--glob1", str(tmp_path / "*_1.tif"),
                 "--batch-size", "2", "--out", str(tmp_path / "out"), "--device", "cpu"],
                tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "3 pairs done, 0 failed" in proc.stdout
    assert os.path.exists(tmp_path / "out" / "f2_0.mat")


def test_timing_helpers(tmp_path):
    timing.force(torch.zeros(2), "not a tensor")
    with timing.trace(str(tmp_path / "trace")):
        with timing.span("matmul"):
            torch.ones(64) @ torch.ones(64)
    files = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]
    assert files
    with open(tmp_path / "trace" / files[0]) as f:
        assert "ofri.matmul" in {e.get("name") for e in json.load(f)["traceEvents"]}


def test_envcheck_reports_without_a_card():
    info = envcheck.report()
    assert info["torch"] == torch.__version__
    assert {"numpy", "scipy", "cuda", "nvcc", "devices", "gpu_name_power_limit",
            "pillow", "matplotlib"} <= info.keys()
    if not torch.cuda.is_available():
        assert info["devices"] == ["cpu"] and info["device_count"] == 0
