"""The yardstick: the roofline work functions against hand-computed values,
the interval union and gaps, and the readers on a hand-made trace."""

import pytest

from pivbench import spec, work
from pivbench.harness import context, trace_faults
from pivbench.drive import Window
from pivbench.trace import DeviceOp, Trace, breakdown, busy_ns, gaps, matches, union
from pivbench.tests._cells import CHECKOUT

BW, PEAK = 3.35e12, 67e12


def test_hs_600_iterations_on_two_levels():
    entries = [{"stage": "hs_iterate", "shape": (256, 256), "count": 600},
               {"stage": "hs_iterate", "shape": (512, 512), "count": 600}]
    # (27 * 600 + 5) = 16205 operations a pixel; operations bound both levels
    want = 16205 * 512 * 512 / PEAK + 16205 * 256 * 256 / PEAK
    assert work.stage_least_seconds("hs_iterate", entries) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(79.26e-6, rel=1e-3)


@pytest.mark.parametrize("k", [0, 1, 37, 60])
def test_liu_shen_at_k_steps(k):
    n = 512 * 512
    want = max(48 * n / BW, 68 * k * n / PEAK)
    got = work.stage_least_seconds("ls_iterate", [{"stage": "ls_iterate", "shape": (512, 512),
                                                   "count": k}])
    assert got == pytest.approx(want, rel=1e-12)
    if k == 0:
        assert got == pytest.approx(48 * n / BW)       # bytes bound a solve of no step


def test_fb_5_rounds_on_two_levels():
    e = [{"stage": "fb_iterate", "shape": (s, s), "count": 5, "params": {"taps": 33}}
         for s in (1024, 2048)]
    # a round: 100 + 5 * 2 * 2 * 33 + 15 = 775 operations a pixel
    want = sum(5 * 775 * s * s / PEAK for s in (1024, 2048))
    assert work.stage_least_seconds("fb_iterate", e) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(303.4e-6, rel=1e-3)
    assert work.stage_ops(e) == pytest.approx(5 * 775 * (1024**2 + 2048**2))


def test_union_of_overlapping_and_disjoint_intervals():
    assert union([(5, 8), (0, 2), (1, 3), (7, 9), (3, 4)]) == [(0, 4), (5, 9)]
    assert union([(0, 10), (2, 3)]) == [(0, 10)]
    assert union([]) == []
    assert busy_ns([(0, 2), (1, 3), (10, 11)]) == 4
    assert gaps([(2, 4), (6, 7)], 0, 10) == [(0, 2), (4, 6), (7, 10)]
    assert gaps([(0, 10)], 0, 10) == []


def test_kernel_names_match_whole_identifiers():
    name = "(anonymous namespace)::hs_block_kernel(float const*, float const*, int)"
    assert matches(name, "hs_block_kernel")
    assert not matches(name, "block_kernel")
    assert not matches("(anonymous namespace)::ls_block_kernel(LsFields)", "hs_block_kernel")
    assert matches("void (anonymous namespace)::warp_pair_kernel<false>(float const*)",
                   "warp_pair_kernel")


def _ctx(ops=None, event_ms=800 / 1e6):
    """A window of 1000 ns with two pairs in one call: an HS kernel, a
    Liu-Shen kernel, an elementwise kernel overlapping the HS one, two
    copies, an entry and a fetch span; the same call untraced spent 100 ns
    in the entry."""
    if ops is None:
        ops = [DeviceOp("Memcpy HtoD (Pinned -> Device)", "htod", 100, 150),
               DeviceOp("(anonymous namespace)::hs_block_kernel(float const*)", "kernel", 150, 350),
               DeviceOp("(anonymous namespace)::ls_block_kernel(LsFields)", "kernel", 350, 450),
               DeviceOp("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 400, 500),
               DeviceOp("Memcpy DtoH (Device -> Pinned)", "dtoh", 700, 800)]
    tr = Trace(ops, [("loop", 0, 1000), ("entry", 0, 100), ("fetch", 600, 900)])
    w = Window(0.0, 1.0, pairs=2, visits={0: 1, 1: 1}, event_ms=event_ms)
    plain = Window(0.0, 0.5e-6, pairs=2, entry_s=100e-9)
    tally = {i: [{"stage": "hs_iterate", "shape": (512, 512), "count": 600},
                 {"stage": "ls_iterate", "shape": (512, 512), "count": 60}] for i in (0, 1)}
    cell = spec.load_cell("ls_hs_512.stream", CHECKOUT / "BENCHMARK.json")
    return cell, context(cell, tr, w, tally, plain)


def test_readers_on_a_hand_made_trace():
    cell, ctx = _ctx()
    assert ctx["busy_ns"] == 400 + 100                      # [100, 500] and [700, 800]

    def read(name):
        return spec.reader(name)(ctx)

    assert read("device_idle_share") == pytest.approx(50.0)
    assert read("entry_host_ms") == pytest.approx(100 / 1e6 / 2)
    assert read("copy_ms") == pytest.approx(150 / 1e6 / 2)
    assert read("torch_ops_ms") == pytest.approx(100 / 1e6 / 2)
    least = 2 * 16205 * 512 * 512 / PEAK
    assert read("hs_iterate_roofline") == pytest.approx(100 * least / 200e-9)
    ls_least = 2 * 68 * 60 * 512 * 512 / PEAK
    assert read("ls_iterate_roofline") == pytest.approx(100 * ls_least / 100e-9)
    assert read("fb_iterate_roofline") is None              # no such kernel, no such work
    assert read("pair_mfu") == pytest.approx(
        100 * 2 * (16205 + 68 * 60) * 512 * 512 / (1e-6 * PEAK))
    assert ctx["trace_check"]["profiler_slowdown"] == pytest.approx(2.0)


def _readings(ctx, cell):
    return {m["name"]: v for m in cell.per_layer
            if (v := spec.reader(m["name"])(ctx)) is not None}


def test_a_whole_trace_has_no_fault():
    cell, ctx = _ctx()
    assert trace_faults(cell, ctx, _readings(ctx, cell)) == []


def test_a_trace_that_ends_early_is_a_fault():
    """The events see the loop's device work end at 800 ns; a trace that
    loses the last copy ends at 500 ns."""
    cell, ctx = _ctx()
    ops = [o for o in ctx["ops"] if o.kind != "dtoh"]
    cell, ctx = _ctx(ops)
    faults = trace_faults(cell, ctx, _readings(ctx, cell))
    assert len(faults) == 1 and "CUDA events" in faults[0], faults


def test_a_call_without_a_stage_kernel_is_a_fault():
    """A trace that misses the Liu-Shen kernel: the stage the cell's roofline
    reads is missing from the call, and the roofline reads nothing."""
    cell, ctx = _ctx()
    ops = [o for o in ctx["ops"] if "ls_block" not in o.name]
    cell, ctx = _ctx(ops)
    faults = trace_faults(cell, ctx, _readings(ctx, cell))
    assert any("stage ls_iterate" in f for f in faults), faults
    assert any("ls_iterate_roofline found nothing" in f for f in faults), faults


def test_breakdown_names_ops_and_gaps():
    cell, ctx = _ctx()
    bd = breakdown(ctx["trace"])
    assert bd["device_ops"][0] == ["hs_block_kernel", 200 / 1e9]
    assert [g[0] for g in bd["idle_gaps"]] == ["fetch", "fetch", "entry"]   # [500, 700], [800, 1000], [0, 100]
    assert bd["idle_gaps"][0][1] == pytest.approx(200 / 1e9)
