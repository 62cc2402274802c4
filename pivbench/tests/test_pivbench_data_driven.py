"""A configuration, a traffic mix, a per-layer metric and a stage's kernel
name are each added as a new file, in a copy of the benchmark, and make a
new cell runnable: no file the benchmark has is edited (only
``BENCHMARK.json`` gains its entries)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from pivbench.tests._cells import CHECKOUT

CONFIG = {
    "name": "hs_48", "registry": "HS_Fs3_4", "source": "a test deployment",
    "height": 48, "width": 48, "bit_depth": 8,
    "particles": {"density": 0.06, "radius": 1.5, "intensity": [0.4, 1.0]},
    "displacement": {"profile": "parabolic", "peak_px": [1.0, 2.0]},
    "pipeline": {"filter_sigma": 3.4, "pyr_levels": 1,
                 "main": {"solver": "horn_schunck", "alphas": [1.0], "niter": 100}},
    "reference_block": 4, "control": "tf32",
    "limits": {"flow_aee_px": 1e-5, "flow_max_px": 1e-4}, "reduced": [],
}
MIX = {"entry": "scan", "stack": 2, "pool": 4, "trace_calls": 2}
METRIC = '''"""The traced loop's wall time per pair, ms."""


def read(ctx):
    lo, hi = ctx["window"]
    return (hi - lo) / 1e6 / ctx["pairs"] if ctx["pairs"] else None
'''
CHILD = """
import json, sys, time
from pathlib import Path
import torch
torch.set_num_threads(1)
import pivbench
from pivbench import drive, harness, spec
drive.WARM_SECONDS = 0.0
root = Path(pivbench.__file__).parent
cell = spec.load_cell("hs_48.stream4", root.parent / "BENCHMARK.json", root)
out = {"package": str(root), "stages": spec.stages(root)}
for trace in (False, True):
    r = harness.run_cell(cell, 2**31 + 3, 0.3, trace, "cpu", time.time())
    out[str(trace)] = {"correct": r["correct"], "metrics": sorted(r["metrics"])}
print(json.dumps(out))
"""



def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench_dir = tmp_path / "pivbench"
    shutil.copytree(CHECKOUT / "pivbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    digests = _digests(bench_dir)

    (bench_dir / "configs" / "hs_48.json").write_text(json.dumps(CONFIG))
    (bench_dir / "traffic" / "stream4.json").write_text(json.dumps(MIX))
    (bench_dir / "metrics" / "loop_ms.py").write_text(METRIC)
    (bench_dir / "stages" / "hs_iterate" / "hs_block2.txt").write_text("hs_block2_kernel\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hs_48", "source": "a test deployment",
                             "file": "pivbench/configs/hs_48.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "hs_48.stream4", "config": "hs_48",
                               "traffic": "stream4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "loop_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "entry",
                               "moves": "pairs_per_s", "workloads": ["hs_48.stream4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = {**os.environ, "PYTHONPATH": str(CHECKOUT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["package"] == str(bench_dir)
    assert "hs_block2_kernel" in r["stages"]["hs_iterate"]
    assert r["False"]["correct"] and r["False"]["metrics"] == ["pairs_per_s", "setup_s"]
    assert r["True"]["correct"] and "loop_ms" in r["True"]["metrics"]
    after = _digests(bench_dir)
    assert {k: after[k] for k in digests} == digests      # nothing that was there changed
