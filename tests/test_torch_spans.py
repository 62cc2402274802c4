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
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_eager_pyramid_span_tree(name):
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=3, max_disp=2.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_config(name, im1, im2, device="cpu")
    assert _tree(prof) == Counter(TREES[name])


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
