"""The port's CUDA-graph pipelines against the eager path on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  Run on the machine with the card, which has no
JAX, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graph.py -q

``compile.compiled_pipeline`` captures one run of a configuration per
(H, W, device) and replays it: every configuration's replay equals its eager
run bit for bit (up to 512^2, and at 2048^2 one configuration a solver), its
capture launches exactly the configuration's kernels (``expected_kernels``)
and a replay none, each replay computes the pair it was given (two pairs in
turns), ``scan_pipeline`` equals the eager path pair by pair (also for the
12-bit calibrated name at 2560 x 2160, K1 on its blocked path), host stacks
staged pair by pair through the two slots equal the per-pair replays and
the whole-stack path, and ``release`` returns the graph's memory and the
slots.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline
from opticalflow_ri_tpu_torch.configs import CONFIGS, base_name, run_config
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, fb_fused, hs_iter, liu_shen_iter, lk_build, lk_iter, poly_expand, tent_sample,
    warp_tent,
)
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda

# every kernel wrapper by the name the kernel tables use; each counts its calls
WRAPPERS = {"hs_jacobi": (hs_iter, "hs_iterate"), "warp_pair": (warp_tent, "warp_pair"),
            "liu_shen": (liu_shen_iter, "liu_shen_iterate"),
            "lk_build": (lk_build, "lk_build_planes"), "lk_gn": (lk_iter, "lk_gn_iterate"),
            "lk_fused": (lk_iter, "lk_fused"), "fb_poly_expand": (poly_expand, "poly_expand"),
            "fb_update_matrices": (tent_sample, "update_matrices"),
            "fb_blur5_flow": (blur5_flow, "blur5_flow"), "fb_fused": (fb_fused, "fb_fused")}


def launches() -> dict:
    return {k: getattr(mod, attr).launches for k, (mod, attr) in WRAPPERS.items()}


LK_CONFIGS = ("denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
              "LK_Fs2_0", "LK_Fs2_0_PyrLvls2")
FB_CONFIGS = ("Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
              "FB_Fs0_0", "FB_Fs0_0_PyrLvls2")


def expected_kernels(name: str) -> set:
    """The kernels a configuration's path launches, and no others.  The LK
    and FB configurations run with warping=False: no warp.  LiuSE_LK_Fs2_0_*
    and LiuSE_FB_Fs0_0_* run Liu-Shen alone (the harness quirk of
    configs.py)."""
    liu_shen = {"liu_shen"} if name.startswith("LiuSE_") else set()
    if name in LK_CONFIGS:
        return {"lk_build", "lk_gn"} | liu_shen
    if name in FB_CONFIGS:
        return {"fb_poly_expand", "fb_update_matrices", "fb_blur5_flow"} | liu_shen
    want = set()
    if not name.startswith("LiuSE_") or "HSchunck" in name:
        want.add("hs_jacobi")
    if name.startswith("LiuSE_"):
        want.add("liu_shen")
    if name.endswith("PyrLvls2"):
        want.add("warp_pair")
    return want


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    return torch.device("cuda", torch.cuda.current_device())


def _pair(shape, seed, dev):
    a, b, _, _ = particle_image_pair(shape=shape, seed=seed, max_disp=2.5)
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


# every configuration up to 512^2, and one configuration a solver at 2048^2
GRAPH_CASES = ([(name, shape) for name in sorted(CONFIGS)
                for shape in [(47, 61), (96, 96), (512, 512)]]
               + [(name, (2048, 2048)) for name in ("HS_Fs3_4", "LiuSE_HS_Fs3_4_PyrLvls2",
                                                    "LK_Fs2_0", "Farneback_Fs0_0")])


@pytest.mark.parametrize("name,shape", GRAPH_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in GRAPH_CASES])
def test_graph_replay_equals_eager(name, shape, dev):
    """The capture (after the eager warm-up) launches exactly the
    configuration's kernels; the replays launch none and equal the eager
    run bit for bit."""
    im1, im2 = _pair(shape, 3, dev)
    fn = compiled_pipeline(name)
    try:
        fn.warm_up(im1, im2)
        before = launches()
        got = fn(im1, im2)  # the capture, then the first replay
        captured = {k for k, n in launches().items() if n > before[k]}
        assert captured == expected_kernels(name)
        after = launches()
        again = fn(im1, im2)
        assert launches() == after
        assert got[0].device == dev and got[0].shape == shape
        want = run_config(name, im1, im2)
        assert _equal(got, want) and _equal(again, want)
    finally:
        fn.release()


@pytest.mark.parametrize("name", ["HS_Fs3_4_PyrLvls2", "LiuSE_HS_Fs3_4_PyrLvls2",
                                  "LK_Fs2_0_PyrLvls2", "Farneback_Fs0_0"])
def test_replays_compute_their_own_pair(name, dev):
    pairs = [_pair((64, 80), seed, dev) for seed in (1, 2)]
    want = [run_config(name, *p) for p in pairs]
    fn = compiled_pipeline(name)
    try:
        for _ in range(2):
            for p, w in zip(pairs, want):
                assert _equal(fn(*p), w)
        # numpy inputs go through pinned memory into the same graph
        a, b = (x.cpu().numpy() for x in pairs[0])
        assert _equal(fn(a, b), want[0])
        # each call returns fresh tensors, not the graph's buffers
        first = fn(*pairs[0])
        fn(*pairs[1])
        assert _equal(first, want[0])
    finally:
        fn.release()


@pytest.mark.parametrize("name", ["HS_Fs3_4", "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0",
                                  "FB_Fs0_0"])
def test_scan_equals_eager_pairs(name, dev):
    pairs = [_pair((47, 61), seed, dev) for seed in range(3)]
    im1s = torch.stack([p[0] for p in pairs])
    im2s = torch.stack([p[1] for p in pairs])
    scan = scan_pipeline(name)
    try:
        us, vs = scan(im1s, im2s)
        assert us.shape == (3, 47, 61) and us.device == dev
        for k, p in enumerate(pairs):
            assert _equal((us[k], vs[k]), run_config(name, *p))
        us2, _ = scan(im1s.cpu().numpy(), im2s.cpu().numpy())
        assert torch.equal(us2, us)
    finally:
        scan.release()


@pytest.mark.parametrize("name", ["LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "HS_Fs3_4_PyrLvls2"])
def test_scan_resident_hs_equals_eager(name, dev):
    """A 512^2 stack through ``scan_pipeline`` of a two-level HS configuration
    (K1 on the resident path at 256^2 and 512^2: one cooperative launch a
    solve, captured into the graph): the capture launches resident solves,
    two a run, the replays none, and every pair equals its eager run, which
    takes two resident solves, bit for bit."""
    pairs = [_pair((512, 512), seed, dev) for seed in range(3)]
    im1s = torch.stack([p[0] for p in pairs])
    im2s = torch.stack([p[1] for p in pairs])
    scan = scan_pipeline(name)
    try:
        before = hs_iter.hs_iterate.resident
        us, vs = scan(im1s, im2s)
        captured = hs_iter.hs_iterate.resident - before
        assert captured > 0 and captured % 2 == 0
        after = hs_iter.hs_iterate.resident
        us2, vs2 = scan(im1s, im2s)
        assert hs_iter.hs_iterate.resident == after
        for k, p in enumerate(pairs):
            before = hs_iter.hs_iterate.resident
            want = run_config(name, *p)
            assert hs_iter.hs_iterate.resident == before + 2
            assert _equal((us[k], vs[k]), want) and _equal((us2[k], vs2[k]), want)
    finally:
        scan.release()


CALIBRATED = "LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06"


def test_calibrated_12bit_graph_and_scan_equal_eager(dev):
    """The 12-bit configuration of pivbench's ``ls_hs12_2560x2160`` at its
    size through both entries: the capture launches the base configuration's
    kernels, K1 as two blocked solves of 75 launches and no resident one; a
    host stack through ``scan_pipeline`` replays the graph, launching
    nothing; every pair equals its eager run bit for bit."""
    shape = (2160, 2560)
    pairs = [particle_image_pair(shape=shape, seed=s, max_disp=2.5, bit_depth=12)[:2]
             for s in (1, 2)]
    im1s, im2s = (np.stack([p[j] for p in pairs]).astype(np.float32) for j in range(2))
    assert im1s.max() > 255.0
    fn, scan = compiled_pipeline(CALIBRATED), scan_pipeline(CALIBRATED)
    hs = hs_iter.hs_iterate

    def k1():
        return hs.resident, hs.blocked, hs.blocked_launches

    try:
        first = tuple(torch.as_tensor(x, device=dev) for x in pairs[0])
        fn.warm_up(*first)
        before, k1_before = launches(), k1()
        got = fn(*first)
        assert {k for k, n in launches().items() if n > before[k]} == expected_kernels(
            base_name(CALIBRATED))
        assert k1() == (k1_before[0], k1_before[1] + 2, k1_before[2] + 150)
        after = launches()
        us, vs = scan(im1s, im2s)
        assert launches() == after
        for k, p in enumerate(pairs):
            k1_before = k1()
            want = run_config(CALIBRATED, *(torch.as_tensor(x, device=dev) for x in p))
            assert k1() == (k1_before[0], k1_before[1] + 2, k1_before[2] + 150)
            assert _equal((us[k], vs[k]), want)
            if k == 0:
                assert _equal(got, want)
        # the calibration reached the solve: the Bits08 alphas give another flow
        plain = run_config(base_name(CALIBRATED), *first)
        assert not _equal(plain, got)
    finally:
        scan.release()


def _host_stack(shape, seeds):
    pairs = [particle_image_pair(shape=shape, seed=s, max_disp=2.5)[:2] for s in seeds]
    return tuple(np.stack([p[j] for p in pairs]).astype(np.float32) for j in range(2))


def _whole_stack(scan, im1s, im2s, dev):
    """The scan as it was before the staging slots: each stack pinned and
    copied to the device whole, then replayed pair by pair from there."""
    return scan(*(torch.from_numpy(s).pin_memory().to(dev) for s in (im1s, im2s)))


@pytest.mark.parametrize("shape", [(512, 512), (333, 517)], ids=["512x512", "333x517"])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_scan_stages_host_stacks_pair_by_pair(k, shape, dev):
    """Host stacks go through the two staging slots pair by pair: the flows
    equal the per-pair replays and the whole-stack path bit for bit, for two
    stacks in turns (slots and input buffers reused), and the counters count
    each pair staged; device stacks stage nothing."""
    name = "LiuSE_HS_Fs3_4_PyrLvls2"
    stacks = [_host_stack(shape, range(s, s + k)) for s in (0, 100)]
    pipe, scan = compiled_pipeline(name), scan_pipeline(name)
    try:
        want = []
        for im1s, im2s in stacks:
            pairs = [pipe(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))
                     for a, b in zip(im1s, im2s)]
            want.append(tuple(torch.stack([p[j] for p in pairs]) for j in range(2)))
            assert _equal(_whole_stack(scan, im1s, im2s, dev), want[-1])
        for _ in range(3):
            for (im1s, im2s), w in zip(stacks, want):
                staged, overlapped = scan.staged, scan.overlapped
                got = scan(im1s, im2s)
                assert scan.staged - staged == k
                assert 0 <= scan.overlapped - overlapped <= k - 1
                assert _equal(got, w)
        staged, overlapped = scan.staged, scan.overlapped
        device_stack = tuple(torch.as_tensor(s, device=dev) for s in stacks[1])
        assert _equal(scan(*device_stack), want[1])
        assert (scan.staged, scan.overlapped) == (staged, overlapped)
    finally:
        scan.release()


def test_release_frees_the_slots(dev):
    im1s, im2s = _host_stack((64, 80), range(3))
    scan = scan_pipeline("HS_Fs3_4")
    pipe = compiled_pipeline("HS_Fs3_4")
    want = scan(im1s, im2s)
    torch.cuda.synchronize()
    (slots,) = pipe._slots.values()
    held = [weakref.ref(t) for t in slots.host]
    assert all(t.is_pinned() and t.shape == (2, 64, 80) for t in slots.host)
    del slots
    scan.release()
    gc.collect()
    assert pipe._slots == {} and all(r() is None for r in held)
    # device stacks never make slots; host stacks make them again
    scan(*(torch.as_tensor(s, device=dev) for s in (im1s, im2s)))
    assert pipe._slots == {}
    assert _equal(scan(im1s, im2s), want) and len(pipe._slots) == 1
    scan.release()


def test_release_frees_the_pool(dev):
    im1, im2 = _pair((512, 512), 0, dev)
    fn = compiled_pipeline("LK_Fs2_0")
    fn(im1, im2)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev)
    fn.release()
    freed = held - torch.cuda.memory_reserved(dev)
    # the graph's pool holds the 2 x 121 shift planes of the LK build
    assert freed >= 2 * 121 * 512 * 512 * 4
    assert _equal(fn(im1, im2), run_config("LK_Fs2_0", im1, im2))  # captures again
    fn.release()


def test_capture_failure_raises(dev):
    """No eager fallback: an error during the capture reaches the caller."""
    from opticalflow_ri_tpu_torch.compile import CompiledPipeline
    from opticalflow_ri_tpu_torch.utils.device import capturing

    def run(a, b, device):
        if capturing():
            raise RuntimeError("refused during capture")
        return a + b, a - b

    fn = CompiledPipeline("HS_Fs0_0")
    fn._run = run
    with pytest.raises(RuntimeError, match="refused during capture"):
        fn(*_pair((32, 32), 0, dev))
    fn.release()
