"""The port's CUDA-graph pipelines against the eager path on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  Run on the machine with the card, which has no
JAX, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graph.py -q

``compile.compiled_pipeline`` captures one run of a configuration per
(H, W, device) and replays it: every configuration's replay equals its eager
run bit for bit, each replay computes the pair it was given (two pairs in
turns), ``scan_pipeline`` equals the eager path pair by pair, and
``release`` returns the graph's memory.
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline
from opticalflow_ri_tpu_torch.configs import CONFIGS, run_config
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("shape", [(47, 61), (96, 96)], ids=["47x61", "96x96"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_replay_equals_eager(name, shape, dev):
    im1, im2 = _pair(shape, 3, dev)
    fn = compiled_pipeline(name)
    try:
        got = fn(im1, im2)
        assert got[0].device == dev and got[0].shape == shape
        assert _equal(got, run_config(name, im1, im2))
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
