"""The program's spans (``utils/timing.span``) on the CPU: nothing is
created without a profiler, the eager pyramid gives its span tree, and a
campaign's trace names the stages of the runner's threads."""

import contextlib
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
from opticalflow_ri_tpu_torch.utils import timing
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refused(name):
        raise AssertionError(f"range {name!r} created with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(timing, "_RecordFunctionFast", refused)
    a, b = timing.span("pin"), timing.span("level1")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_under_a_profiler_is_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("solve"):
            torch.ones(8) + 1
    spans = [e for e in prof.profiler.kineto_results.events() if e.name() == "ofri.solve"]
    assert len(spans) == 1
    # not a user annotation, which the profiler would draw again over its device work
    assert not spans[0].is_user_annotation()


def _tree(prof) -> Counter:
    """(parent, child) span names, ``ofri.`` dropped, counted: each span's
    parent is the innermost span of its thread that holds it."""
    spans = [(e.name()[5:], e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("ofri.")]
    edges = Counter()
    for name, s, e, t in spans:
        holders = [(e2 - s2, n2) for n2, s2, e2, t2 in spans
                   if t2 == t and s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        edges[(min(holders)[1] if holders else None, name)] += 1
    return edges


LEVELS = {(None, "level1"): 1, (None, "level2"): 1,
          ("level1", "resize"): 2, ("level1", "solve"): 1, ("level1", "accumulate"): 1,
          ("level2", "upsample"): 1, ("level2", "solve"): 1, ("level2", "accumulate"): 1}
TREES = {
    # FILTER 3.4 and FILTER_OPT 0.48 prefilter each level; K1's warp from level 2
    "LiuSE_PyHSchunck_Fs3_4_PyrLvls2": {
        **LEVELS, ("level1", "prefilter"): 2, ("level1", "refine"): 1,
        ("level2", "warp"): 1, ("level2", "prefilter"): 2, ("level2", "refine"): 1,
        ("solve", "derivatives"): 2, ("solve", "iterate"): 2,
        ("refine", "precompute"): 2, ("refine", "iterate"): 2},
    # FILTER 0 and Farneback's defaults (no warping): one expansion a frame a level
    "FB_Fs0_0_PyrLvls2": {**LEVELS, ("solve", "expand"): 4, ("solve", "iterate"): 2},
    # FILTER 2.0 and FILTER_OPT 0.48 prefilter each level; LK's defaults (no warping):
    # the solve fields, K6's planes and K7's loop a level, then Liu-Shen
    "LiuSE_denseLK_Fs2_0_PyrLvls2": {
        **LEVELS, ("level1", "prefilter"): 2, ("level1", "refine"): 1,
        ("level2", "prefilter"): 2, ("level2", "refine"): 1,
        ("solve", "precompute"): 2, ("solve", "planes"): 2, ("solve", "iterate"): 2,
        ("refine", "precompute"): 2, ("refine", "iterate"): 2},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_eager_pyramid_span_tree(name):
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=3, max_disp=2.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_config(name, im1, im2, device="cpu")
    assert _tree(prof) == Counter(TREES[name])


LK_STAGES = ("ofri.precompute", "ofri.planes", "ofri.iterate")


def _ops_outside_stages(prof) -> tuple:
    """(solve spans, the ``aten::`` ops inside a solve span but outside
    its three LK stage spans, by name)."""
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    solves = [e for e in events if e[0] == "ofri.solve"]
    stages = [e for e in events if e[0] in LK_STAGES]
    outside = Counter()
    for _, s, e, t in solves:
        for name, s2, e2, t2 in events:
            if not name.startswith("aten::") or t2 != t or not (s <= s2 and e2 <= e):
                continue
            if not any(t3 == t and s3 <= s2 and e2 <= e3 for _, s3, e3, t3 in stages):
                outside[name] += 1
    return solves, outside


def test_lk_solve_ops_lie_in_its_stage_spans():
    """Every op of dense LK's solve, on both levels, lies under
    ``ofri.precompute``, ``ofri.planes`` or ``ofri.iterate``."""
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=3, max_disp=2.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_config("LiuSE_denseLK_Fs2_0_PyrLvls2", im1, im2, device="cpu")
    solves, outside = _ops_outside_stages(prof)
    assert len(solves) == 2
    assert not outside, outside


SHARDED_LK = """
import json, sys
from collections import Counter
import torch
from torch.profiler import ProfilerActivity, profile
from opticalflow_ri_tpu_torch.parallel import distributed
from opticalflow_ri_tpu_torch.parallel.mesh import make_mesh
from opticalflow_ri_tpu_torch.parallel.sharded_kernel import lk_solve_sharded_kernel
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair
distributed.initialize(sys.argv[1], 1, 0, device="cpu")
mesh = make_mesh(shape=(1, 1, 1), device_type="cpu")
im1, im2, _, _ = particle_image_pair(shape=(48, 64), seed=4, max_disp=2.0)
a, b = torch.from_numpy(im1), torch.from_numpy(im2)
z = torch.zeros_like(a)
with profile(activities=[ProfilerActivity.CPU]) as prof:
    lk_solve_sharded_kernel(mesh, a, b, z, z)
names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("ofri."))
print(json.dumps(names))
"""


def test_sharded_lk_solve_opens_the_stage_spans(tmp_path):
    """The rows-sharded solve on a one-rank gloo group opens the three spans
    once each (the halo exchange under ``ofri.precompute``)."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", SHARDED_LK, f"file://{tmp_path}/rdv"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert names == {"ofri.precompute": 1, "ofri.planes": 1, "ofri.iterate": 1}, names


def test_runner_trace_names_its_threads_stages(tmp_path):
    """The producer's and the writer's spans reach a campaign's trace, on
    threads of their own (the trace starts at the second batch)."""
    pairs = []
    for i in range(10):
        im1, im2, _, _ = particle_image_pair(shape=(48, 48), seed=i)
        paths = [str(tmp_path / f"f{i}_{k}.tif") for k in (0, 1)]
        for p, im in zip(paths, (im1, im2)):
            Image.fromarray(im.astype(np.uint8)).save(p)
        pairs.append((f"pair{i}", *paths))
    trace_dir = tmp_path / "trace"
    state = FlowBatchRunner("HS_Fs0_0", batch_size=1, output_dir=str(tmp_path / "out"),
                            profile_dir=str(trace_dir), device="cpu").run(pairs)
    assert len(state["done"]) == 10
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    threads = {}
    for e in events:
        if str(e.get("name", "")).startswith("ofri."):
            threads.setdefault(e["name"], set()).add(e["tid"])
    assert {"ofri.decode", "ofri.upload", "ofri.write", "ofri.level1"} <= threads.keys()
    main = threads["ofri.level1"]
    assert not main & (threads["ofri.decode"] | threads["ofri.write"])
    assert not threads["ofri.decode"] & threads["ofri.write"]
