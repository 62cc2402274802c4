"""What a run loads: neither JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port."""

import json
import os
import subprocess
import sys

from pivbench import run
from pivbench.tests._cells import CHECKOUT

REHEARSAL = """
import json, sys, time
import torch
torch.set_num_threads(1)
from pivbench.tests._cells import rehearse, small_cell
r = rehearse(small_cell("ls_hs_512.single", size=32, pool=2), seconds=0.2)
print(json.dumps({"correct": r["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE = """
import json, sys
import torch
from pivbench.reference import pipeline
a = torch.rand(2, 32, 32) * 255
for cfg in ("ls_hs_512", "fb_2048"):
    recipe = json.load(open(f"pivbench/configs/{cfg}.json"))["pipeline"]
    pipeline(a, a.flip(-1), recipe)
print(json.dumps(sorted(sys.modules)))
"""


def _child(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cell_rehearsal_loads_no_jax():
    r = _child(REHEARSAL)
    assert r["correct"]
    assert "opticalflow_ri_tpu_torch" in r["modules"]          # the port did run
    assert not set(r["modules"]) & run.FORBIDDEN, set(r["modules"]) & run.FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _child(REFERENCE)
    assert "pivbench.reference.farneback" in mods
    assert not [m for m in mods if m.split(".")[0].startswith("opticalflow_ri_tpu")]


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "opticalflow_ri_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "opticalflow_ri_tpu.ops", object())
    assert run.loaded_forbidden() == ["opticalflow_ri_tpu.ops"]
