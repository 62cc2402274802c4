"""The entry's spans and a graph replay's device ops on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  Run on the machine with the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_spans.py -q

A replay of ``compile.compiled_pipeline`` launches, in order, the device
ops of one eager run of its configuration: the eager run names them by
position.  The entry's spans appear as many times as a call makes them,
and none of the program's spans has a shadow on the device timeline.
"""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline
from opticalflow_ri_tpu_torch.configs import build_config
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda

NAMES = ["LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "FB_Fs0_0_PyrLvls2"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    return torch.device("cuda", torch.cuda.current_device())


def _pair(seed=0, shape=(256, 256)):
    a, b, _, _ = particle_image_pair(shape=shape, seed=seed, max_disp=2.5)
    return a, b


def _op(name: str) -> str:
    """A device op's name, but a copy or a set by its kind: a graph runs a
    device-to-device copy node as a kernel named ``memcpy*``."""
    if name.startswith(("Memcpy DtoD", "memcpy")):
        return "copy"
    return "set" if name.startswith(("Memset", "memset")) else name


def _events(prof):
    """(device ops as (name, corr, start), host calls by corr, spans)."""
    ops, calls, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.correlation_id(), e.start_ns()))
        elif e.name().startswith("cu"):
            calls[e.correlation_id()] = (e.name(), e.start_ns())
        elif e.name().startswith("ofri.") or e.name() == "label":
            spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(ops, key=lambda o: o[2]), calls, spans


@pytest.mark.parametrize("name", NAMES)
def test_a_replay_launches_the_eager_runs_ops_in_order(dev, name):
    a, b = _pair()
    pipe = compiled_pipeline(name)
    pipe(a, b, device=dev)                   # warm-up and capture
    da, db = (torch.as_tensor(x, device=dev) for x in (a, b))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("label"):
            build_config(name).run(da, db, device=dev)
            torch.cuda.synchronize()
        for _ in range(2):
            pipe(a, b, device=dev)
        torch.cuda.synchronize()
    ops, calls, spans = _events(prof)
    # the program's spans draw nothing on the device timeline: device activity
    # read from the trace is the work alone
    assert not [n for n, _, _ in ops if n.startswith("ofri.")]
    (_, lo, hi), = [s for s in spans if s[0] == "label"]
    eager = [_op(n) for n, c, _ in ops if c in calls and lo <= calls[c][1] <= hi]
    replays = [c for c, (call, _) in calls.items() if call.startswith("cudaGraphLaunch")]
    assert len(eager) > 50 and len(replays) == 2
    for c in replays:
        assert [_op(n) for n, c2, _ in ops if c2 == c] == eager
    # every eager op ran under a span of the pyramid
    levels = [(s, e) for n, s, e in spans if n.startswith("ofri.level")]
    launched = [calls[c][1] for _, c, _ in ops if c in calls and lo <= calls[c][1] <= hi]
    assert all(any(s <= t <= e for s, e in levels) for t in launched)
    pipe.release()


def test_entry_spans_per_call(dev):
    a, b = _pair(shape=(128, 128))
    pipe = compiled_pipeline(NAMES[0])
    scan = scan_pipeline(NAMES[0])
    stack = [torch.stack([torch.as_tensor(x)] * 3).numpy() for x in (a, b)]
    pipe(a, b, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pipe(a, b, device=dev)
        torch.cuda.synchronize()
    got = Counter(n for n, _, _ in _events(prof)[2])
    # a frame is pinned and copied in one span each, two frames a call; the
    # pyramid's spans ran at capture, unprofiled, and a replay opens none
    assert got == Counter({"ofri.pin": 6, "ofri.h2d": 6, "ofri.replay": 3, "ofri.clone": 3})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan(*stack, device=dev)
        torch.cuda.synchronize()
    got = Counter(n for n, _, _ in _events(prof)[2])
    # the stacks are pinned and copied once; each pair copies its device frames
    assert got == Counter({"ofri.pin": 2, "ofri.h2d": 2 + 2 * 3, "ofri.replay": 3,
                           "ofri.gather": 3})
    pipe.release()
