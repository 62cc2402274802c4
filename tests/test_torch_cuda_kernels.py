"""The port's Hopper kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  The machine with the card needs no JAX, so the
file does not use tests/conftest.py (which imports jax); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Built with -fmad=false, every kernel's flow equals its plain version's bit
for bit; the Liu-Shen error, reduced in another order, agrees to 1e-5
relative, and the Liu-Shen stop comes at the same iteration, also when it
falls inside one of the kernel's launches of T steps.  The HS kernel
is held at every niter mod T (its iterations per launch) and at several T.
The LK build equals its plain version bit for bit, with the symmetric, the
asymmetric and a four-run window; so do the GN loop (px, py and status, on
inputs whose pixels stop at every step from 0 to 5) and the fused build+GN
(clusters of 8 and of 16, the three windows, a partial last tile).  The three Farneback kernels
(updateMatrices, window blur + solve, the fused loop) equal their plain
versions bit for bit; the fused loop from 2x2 to 2048^2, at 0 to 5 rounds,
1 to 129 taps and with the exact gather.
"""

import ctypes

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec, poly_expansion
from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, build, fb_fused, hs_iter, liu_shen_iter, lk_build, lk_iter, tent_sample, warp_tent,
)
from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda


def aee(u, v, u_ref, v_ref):
    return float(np.mean(np.hypot(u - u_ref, v - v_ref)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    return torch.device("cuda")


def _rand(rng, shape, lo, hi, dev):
    return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)


T = hs_iter.STEPS_PER_LAUNCH
HS_NITERS = [0, 1, T - 1, T, T + 1, 45, 600]
HS_CASES = ([(shape, n) for shape in [(2, 2), (3, 517), (47, 61), (333, 517), (512, 512)]
             for n in HS_NITERS] + [((2048, 2048), n) for n in (0, 1, T + 1)])


def _hs_inputs(dev, shape, seed=0):
    rng = np.random.default_rng(seed)
    fx, fy, ft = hs_derivatives(_rand(rng, shape, 0, 255, dev), _rand(rng, shape, 0, 255, dev))
    return fx, fy, ft, _rand(rng, shape, -2, 2, dev), _rand(rng, shape, -2, 2, dev)


@pytest.mark.parametrize("shape,niter", HS_CASES, ids=[f"{s[0]}x{s[1]}-{n}" for s, n in HS_CASES])
def test_hs_kernel_equals_plain(dev, shape, niter):
    """Every niter mod T (the launches' block depth), 600 as the PyHSchunck
    configs run it, and shapes smaller than the halo."""
    fx, fy, ft, u0, v0 = _hs_inputs(dev, shape)
    before = hs_iter.hs_iterate.launches
    got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, niter)
    want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter)
    torch.cuda.synchronize()
    assert hs_iter.hs_iterate.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("steps", [1, 3, 16, hs_iter.MAX_STEPS_PER_LAUNCH])
@pytest.mark.parametrize("shape", [(2, 2), (333, 517)])
def test_hs_kernel_block_depths_equal_plain(dev, steps, shape, monkeypatch):
    fx, fy, ft, u0, v0 = _hs_inputs(dev, shape, seed=1)
    monkeypatch.setattr(hs_iter, "STEPS_PER_LAUNCH", steps)
    got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, 45)
    want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, 45)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(2, 3), (47, 61), (333, 517)])
@pytest.mark.parametrize("dmax", [4.0, 20.0])
def test_warp_kernel_equals_plain(dev, shape, dmax):
    rng = np.random.default_rng(1)
    args = [_rand(rng, shape, 0, 255, dev) for _ in range(2)]
    args += [_rand(rng, shape, -dmax, dmax, dev) for _ in range(4)]
    before = warp_tent.warp_pair.launches
    got = warp_tent.warp_pair(*args)
    want = warp_tent.warp_pair_plain(*args)
    torch.cuda.synchronize()
    assert warp_tent.warp_pair.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _ls_inputs(rng, shape, dev, h=10.0):
    a, b = _rand(rng, shape, 1, 255, dev), _rand(rng, shape, 1, 255, dev)
    fields = liu_shen_precompute(a / a.max(), b / b.max(), h)
    return fields, _rand(rng, shape, -0.5, 0.5, dev), _rand(rng, shape, -0.5, 0.5, dev)


def _ls_check(got, want):
    """Same iteration count, the flow bit for bit, err to 1e-5 relative."""
    assert int(got[3]) == int(want[3])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dim() == 0 and got[2].dtype == torch.float32
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5, atol=0)


T_LS = liu_shen_iter.STEPS_PER_LAUNCH
LS_SHAPES = [(2, 2), (3, 517), (47, 61), (333, 517), (512, 512), (2048, 2048)]
LS_COUNTS = sorted({0, 1, 2, 7, T_LS, T_LS + 1, 60})


@pytest.mark.parametrize("shape", LS_SHAPES)
@pytest.mark.parametrize("max_iter", LS_COUNTS)
def test_ls_kernel_fixed_count_equals_plain(dev, shape, max_iter):
    fields, u0, v0 = _ls_inputs(np.random.default_rng(2), shape, dev)
    before = liu_shen_iter.liu_shen_iterate.launches
    got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, max_iter, 0.0)
    want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, max_iter, 0.0)
    torch.cuda.synchronize()
    assert liu_shen_iter.liu_shen_iterate.launches == before + 1
    assert int(got[3]) == max_iter
    _ls_check(got, want)


def ls_stop_tol(fields, u0, v0, residue, steps, max_iter=60):
    """(k, tol): a tol that stops the plain solve after k < max_iter steps,
    k = residue mod ``steps``, the errs of steps k-1 and k each at least 0.1%
    away from it; k from 2 up."""
    errs, u, v = [], u0, v0
    for _ in range(max_iter):
        un, vn = liu_shen_iter.liu_shen_iteration(u, v, fields, 10.0)
        errs.append(float((torch.linalg.norm(un - u) + torch.linalg.norm(vn - v)) / u.numel()))
        u, v = un, vn
    for k in range(2, max_iter):
        tol = float(np.sqrt(errs[k - 2] * errs[k - 1]))
        if k % steps == residue and errs[k - 1] < 0.999 * tol and min(errs[:k - 1]) > 1.001 * tol:
            return k, tol
    raise AssertionError(f"no tol stops at k = {residue} mod {steps}: errs {errs}")


@pytest.mark.parametrize("shape", LS_SHAPES)
@pytest.mark.parametrize("residue", [0, 1, T_LS - 1], ids=["k=0modT", "k=1modT", "k=-1modT"])
def test_ls_kernel_early_stop_equals_plain(dev, shape, residue):
    """A tol that stops both after k of at most 60 steps, k at the last, the
    first and the next-to-last step of a launch: the kernel returns the state
    of step k (replayed when k ends no launch)."""
    fields, u0, v0 = _ls_inputs(np.random.default_rng(3), shape, dev)
    k, tol = ls_stop_tol(fields, u0, v0, residue % T_LS, T_LS)
    got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, 60, tol)
    want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, 60, tol)
    torch.cuda.synchronize()
    assert int(want[3]) == k
    _ls_check(got, want)


def test_wrappers_reject_bad_tensors(dev):
    z = torch.zeros((16, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        hs_iter.hs_iterate(z, z, z, z.t(), z, 1.0, 1)
    with pytest.raises(TypeError, match="float32"):
        warp_tent.warp_pair(z, z, z, z, z, z.double())
    with pytest.raises(ValueError, match="at least 2x2"):
        one = torch.zeros((1, 16), device=dev)
        hs_iter.hs_iterate(one, one, one, one, one, 1.0, 1)
    with pytest.raises(ValueError, match="one .H, W. shape"):
        liu_shen_iter.liu_shen_iterate(1.0, (z,) * 8, z, torch.zeros((16, 8), device=dev), 1, 0.0)


EDGES = list(range(16))  # every mask of TOP | BOTTOM | LEFT | RIGHT


@pytest.mark.parametrize("shape", [(47, 61), (333, 517)])
@pytest.mark.parametrize("edges", EDGES)
def test_hs_kernel_masked_equals_plain(dev, shape, edges):
    """The per-side border mask of a sharded tile: the whole array, apron
    edges included, bit for bit, at 1, T-1 and T iterations."""
    fx, fy, ft, u0, v0 = _hs_inputs(dev, shape, seed=5)
    for niter in (1, T - 1, T):
        got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, niter, edges)
        want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter, edges)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(47, 61), (333, 517)])
@pytest.mark.parametrize("edges", EDGES)
def test_ls_kernel_masked_equals_plain(dev, shape, edges):
    """The mask with the stop (tol 0: 1 and T steps) and without it
    (2T + 1 steps, err NaN, k = max_iter)."""
    fields, u0, v0 = _ls_inputs(np.random.default_rng(6), shape, dev)
    for n, stop in ((1, True), (T_LS, True), (2 * T_LS + 1, False)):
        got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, n, 0.0, edges, stop)
        want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, n, 0.0, edges, stop)
        torch.cuda.synchronize()
        assert int(got[3]) == int(want[3]) == n
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(torch.isnan(got[2])) == (not stop)


@pytest.mark.parametrize("name", ["HS_Fs3_4", "HS_Fs3_4_PyrLvls2", "PyHSchunck_Fs3_4_PyrLvls2"])
def test_pipeline_on_card_matches_cpu(dev, name):
    im1, im2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    hs_before, warp_before = hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches
    gu, gv = run_config(name, im1, im2, device=dev)
    cu, cv = run_config(name, im1, im2, device="cpu")
    assert hs_iter.hs_iterate.launches > hs_before
    assert (warp_tent.warp_pair.launches > warp_before) == name.endswith("PyrLvls2")
    assert aee(gu.cpu().numpy(), gv.cpu().numpy(), cu.numpy(), cv.numpy()) <= 5e-6


@pytest.mark.parametrize("name", ["LiuSE_HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
                                  "LiuSE_LK_Fs2_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2"])
def test_liu_shen_pipeline_on_card_matches_cpu(dev, name):
    im1, im2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    ls_before, warp_before = liu_shen_iter.liu_shen_iterate.launches, warp_tent.warp_pair.launches
    hs_before = hs_iter.hs_iterate.launches
    gu, gv = run_config(name, im1, im2, device=dev)
    cu, cv = run_config(name, im1, im2, device="cpu")
    assert liu_shen_iter.liu_shen_iterate.launches > ls_before
    assert warp_tent.warp_pair.launches > warp_before
    assert (hs_iter.hs_iterate.launches > hs_before) == ("PyHSchunck" in name)
    assert aee(gu.cpu().numpy(), gv.cpu().numpy(), cu.numpy(), cv.numpy()) <= 5e-6


# ---------------------------------------------------------------- dense LK

LK_NAMES = ["denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
            "LK_Fs2_0", "LK_Fs2_0_PyrLvls2"]
ASYMS = [(0, 0, 0, 0), (1, 0, 0, 1), (0, 1, 0, 1)]


def _lk_problem(dev, shape, asym=(0, 0, 0, 0), dmax=4.0, seed=4):
    """The kernels' inputs for a rolled, noisy random pair and a random
    initial flow of |d| <= dmax."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    u0, v0 = (torch.tensor(rng.uniform(-dmax, dmax, shape).astype(np.float32), device=dev)
              for _ in range(2))
    return lk_kernel_inputs(torch.tensor(a, device=dev), torch.tensor(b, device=dev), u0, v0,
                            asym=asym)


# four runs (the most a run table holds), lengths 4, 6, 15 and 4 in y and
# 27, 1, 2 and 2 in x: every ladder form, from no stage to three
FOUR_RUNS_Y = ((0, 3), (5, 10), (12, 26), (28, 31))
FOUR_RUNS_X = ((0, 26), (27, 27), (28, 29), (30, 31))
LK_BUILD_WINDOWS = ASYMS + ["four_runs"]


@pytest.mark.parametrize("shape", [(2, 2), (47, 61), (333, 517), (512, 512)])
@pytest.mark.parametrize("window", LK_BUILD_WINDOWS, ids=str)
def test_lk_build_kernel_equals_plain(dev, shape, window):
    asym = window if window != "four_runs" else (0, 0, 0, 0)
    slab, g_pair, _, runs_y, runs_x = _lk_problem(dev, shape, asym)
    if window == "four_runs":
        runs_y, runs_x = FOUR_RUNS_Y, FOUR_RUNS_X
    before = lk_build.lk_build_planes.launches
    got = lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)
    want = lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x)
    torch.cuda.synchronize()
    assert lk_build.lk_build_planes.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (121, *shape)
        assert torch.equal(g, w)


def _lk_check(got, want):
    """px, py and status bit for bit."""
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _lk_gn_input(dev, shape, case):
    """(t1, t2, fields) of the GN kernel: the rolled pair's planes with a
    calibrated or a wild random flow; the particle pair from zero flow (the
    configs' smooth input); or 'stops': a flat band (singular windows), some
    origins beyond the bail bounds, the rest |d| <= 4, so that pixels end
    their loop at every step from 0 to 5."""
    if case == "smooth":
        im1, im2, _, _ = particle_image_pair(shape=shape, seed=0)
        z = torch.zeros(shape, device=dev)
        slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
            torch.tensor(im1, device=dev), torch.tensor(im2, device=dev), z, z)
    elif case == "stops":
        rng = np.random.default_rng(8)
        a = rng.uniform(0, 255, shape).astype(np.float32)
        a[:, : shape[1] // 4] = 7.0
        b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
        u0, v0 = (rng.uniform(-4, 4, shape).astype(np.float32) for _ in range(2))
        u0[::3, ::2] = 70.0
        v0[1::4, 1::3] = -60.0
        slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
            *(torch.tensor(x, device=dev) for x in (a, b, u0, v0)))
    else:
        slab, g_pair, fields, runs_y, runs_x = _lk_problem(
            dev, shape, dmax={"calibrated": 4.0, "wild": 20.0}[case])
    planes = lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x)
    for f in (*planes, *fields):  # the kernels' contract on their inputs (lk_iter.py)
        assert bool(torch.isfinite(f).all())
    assert not bool(((fields[6] == 0) & torch.signbit(fields[6])).any())
    return (*planes, *fields)


@pytest.mark.parametrize("shape", [(2, 2), (47, 61), (333, 517)])
@pytest.mark.parametrize("n_iter", [0, 1, 5])
@pytest.mark.parametrize("dmax", [4.0, 20.0], ids=["calibrated", "wild"])
def test_lk_gn_kernel_equals_plain(dev, shape, n_iter, dmax):
    slab, g_pair, fields, runs_y, runs_x = _lk_problem(dev, shape, dmax=dmax)
    t1, t2 = lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x)
    before = lk_iter.lk_gn_iterate.launches
    got = lk_iter.lk_gn_iterate(t1, t2, *fields, n_iter, 5, 13)
    want = lk_iter.lk_gn_iterate_plain(t1, t2, *fields, n_iter, 5, 13)
    torch.cuda.synchronize()
    assert lk_iter.lk_gn_iterate.launches == before + 1
    _lk_check(got, want)


@pytest.mark.parametrize("shape", [(47, 61), (333, 517), (512, 512)])
@pytest.mark.parametrize("case", ["calibrated", "wild", "smooth", "stops"])
def test_lk_gn_kernel_exits_equal_plain(dev, shape, case):
    """The per-pixel exit, n_iter 0, 1, 5."""
    args = _lk_gn_input(dev, shape, case)
    for n_iter in (0, 1, 5):
        got = lk_iter.lk_gn_iterate(*args, n_iter, 5, 13)
        want = lk_iter.lk_gn_iterate_plain(*args, n_iter, 5, 13)
        torch.cuda.synchronize()
        _lk_check(got, want)


@pytest.mark.parametrize("shape", [(2, 2), (47, 61), (333, 517), (512, 512)])
@pytest.mark.parametrize("n_iter", [0, 1, 5])
@pytest.mark.parametrize("asym", ASYMS[:2] + ["four_runs"], ids=str)
@pytest.mark.parametrize("R", [5, 2])
def test_lk_fused_kernel_equals_plain(dev, shape, n_iter, asym, R):
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    u0, v0 = (torch.tensor(rng.uniform(-20, 20, shape).astype(np.float32), device=dev)
              for _ in range(2))
    slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
        torch.tensor(a, device=dev), torch.tensor(b, device=dev), u0, v0,
        asym=asym if asym != "four_runs" else (0, 0, 0, 0), max_shift=R)
    if asym == "four_runs":
        runs_y, runs_x = FOUR_RUNS_Y, FOUR_RUNS_X
    before = lk_iter.lk_fused.launches
    got = lk_iter.lk_fused(slab, g_pair, *fields, n_iter, R, 13, runs_y, runs_x)
    want = lk_iter.lk_fused_plain(slab, g_pair, *fields, n_iter, R, 13, runs_y, runs_x)
    torch.cuda.synchronize()
    assert lk_iter.lk_fused.launches == before + 1
    _lk_check(got, want)


@pytest.mark.parametrize("shape,R", [((2048, 2048), 5), ((333, 517), 6), ((333, 517), 7)],
                         ids=["2048-R5", "333x517-R6", "333x517-R7"])
def test_lk_fused_kernel_large_and_clusters_equal_plain(dev, shape, R):
    """2048^2, and clusters of 16 blocks (R = 6 and 7 need them)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    u0, v0 = (torch.tensor(rng.uniform(-4, 4, shape).astype(np.float32), device=dev)
              for _ in range(2))
    slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
        torch.tensor(a, device=dev), torch.tensor(b, device=dev), u0, v0, max_shift=R)
    assert lk_iter.fused_plan(R)[0] == (8 if R <= 5 else 16)
    got = lk_iter.lk_fused(slab, g_pair, *fields, 5, R, 13, runs_y, runs_x)
    want = lk_iter.lk_fused_plain(slab, g_pair, *fields, 5, R, 13, runs_y, runs_x)
    torch.cuda.synchronize()
    _lk_check(got, want)


def test_lk_fused_plan_matches_kernel(dev):
    """The wrapper's plan asks for the shared memory the kernel computes,
    and an R whose planes fit no cluster raises before any launch."""
    lib = build.load_library()
    lib.ofri_lk_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ofri_lk_fused_smem_bytes.restype = ctypes.c_size_t
    for R in range(1, 8):
        size, _, nbytes = lk_iter.fused_plan(R)
        assert lib.ofri_lk_fused_smem_bytes(R, size) == nbytes
    slab, g_pair, fields, runs_y, runs_x = _lk_problem(dev, (16, 24))
    before = lk_iter.lk_fused.launches
    with pytest.raises(ValueError, match="do not fit"):
        lk_iter.lk_fused(torch.zeros((16 + 31 + 16, 24 + 31 + 16), device=dev), g_pair,
                         *fields, 5, 8, 13, runs_y, runs_x)
    assert lk_iter.lk_fused.launches == before


def test_lk_wrappers_reject_bad_tensors(dev):
    slab, g_pair, fields, runs_y, runs_x = _lk_problem(dev, (16, 24))
    t1, t2 = lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)
    with pytest.raises(ValueError, match="expected shape"):
        lk_build.lk_build_planes(slab[1:], g_pair, 13, 5, runs_y, runs_x)
    with pytest.raises(TypeError, match="float32"):
        lk_build.lk_build_planes(slab, g_pair.double(), 13, 5, runs_y, runs_x)
    with pytest.raises(ValueError, match="contiguous"):
        lk_iter.lk_gn_iterate(t1.transpose(1, 2).contiguous().transpose(1, 2), t2, *fields, 5, 5,
                              13)
    with pytest.raises(ValueError, match="expected shape"):
        lk_iter.lk_gn_iterate(t1[:100], t2, *fields, 5, 5, 13)
    with pytest.raises(ValueError, match="one .H, W. shape"):
        lk_iter.lk_gn_iterate(t1, t2, *fields[:-1], fields[-1][:8], 5, 5, 13)
    with pytest.raises(ValueError, match="do not match"):
        small = _lk_problem(dev, (8, 24))[2]
        lk_iter.lk_fused(slab, g_pair, *small, 5, 5, 13, runs_y, runs_x)
    with pytest.raises(ValueError, match="CUDA device"):
        lk_iter.lk_fused(slab, g_pair, *fields[:-1], fields[-1].cpu(), 5, 5, 13, runs_y, runs_x)


@pytest.mark.parametrize("name", LK_NAMES)
def test_lk_pipeline_on_card_matches_cpu(dev, name):
    im1, im2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    counters = (lk_build.lk_build_planes, lk_iter.lk_gn_iterate, warp_tent.warp_pair,
                liu_shen_iter.liu_shen_iterate)
    before = [c.launches for c in counters]
    gu, gv = run_config(name, im1, im2, device=dev)
    cu, cv = run_config(name, im1, im2, device="cpu")
    launched = [c.launches > b for c, b in zip(counters, before)]
    assert launched == [True, True, False, name.startswith("LiuSE_")]
    assert aee(gu.cpu().numpy(), gv.cpu().numpy(), cu.numpy(), cv.numpy()) <= 5e-6


# ---------------------------------------------------------------- Farneback

FB_NAMES = ["Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
            "FB_Fs0_0", "FB_Fs0_0_PyrLvls2"]
FB_SHAPES = [(2, 2), (5, 7), (47, 61), (333, 517)]
WINDOWS = {"gaussian": _window_blur_spec(33, True), "box": _window_blur_spec(33, False)}


def _fb_expansions(dev, shape, seed=5):
    """R0, R1 of a particle pair cut to ``shape`` (PIV-like, so the 2x2 solve
    is well conditioned), on the card."""
    big = (max(shape[0], 16), max(shape[1], 16))
    im1, im2, _, _ = particle_image_pair(shape=big, seed=seed)
    return [poly_expansion(torch.tensor(im[:shape[0], :shape[1]], device=dev), 7, 1.5)
            .contiguous() for im in (im1, im2)]


def _fb_flow(dev, shape, dmax, seed=6):
    rng = np.random.default_rng(seed)
    return _rand(rng, shape, -dmax, dmax, dev), _rand(rng, shape, -dmax, dmax, dev)


@pytest.mark.parametrize("shape", FB_SHAPES)
@pytest.mark.parametrize("dmax", [4.0, 20.0], ids=["calibrated", "wild"])
@pytest.mark.parametrize("R", [5, None], ids=["R5", "gather"])
def test_update_matrices_kernel_equals_plain(dev, shape, dmax, R):
    r0, r1 = _fb_expansions(dev, shape)
    fx, fy = _fb_flow(dev, shape, dmax)
    before = tent_sample.update_matrices.launches
    got = tent_sample.update_matrices(fx, fy, r0, r1, R)
    want = tent_sample.update_matrices_plain(fx, fy, r0, r1, R)
    torch.cuda.synchronize()
    assert tent_sample.update_matrices.launches == before + 1
    assert got.shape == (5, *shape)
    assert torch.equal(got, want)


BLUR_SHAPES = [(2, 2), (3, 517), (5, 7), (47, 61), (333, 517), (512, 512), (2048, 2048)]
BLUR_WINDOWS = ["gaussian", "box", "gaussian-scaled"]


def blur_window(window, n):
    """(taps, mode, scale) of an n-tap window: the Gaussian ("mirror", no
    post-scale), the box ("nearest", scale 1/n^2), or the Gaussian with a
    post-scale of 0.37."""
    taps, mode, scale = _window_blur_spec(n, window != "box")
    return taps, mode, (0.37 if window == "gaussian-scaled" else scale)


@pytest.mark.parametrize("shape", BLUR_SHAPES)
@pytest.mark.parametrize("window", BLUR_WINDOWS)
@pytest.mark.parametrize("n", [1, 3, 33, 129])
def test_blur5_flow_kernel_equals_plain(dev, shape, window, n):
    r0, r1 = _fb_expansions(dev, shape)
    fx, fy = _fb_flow(dev, shape, 2.0)
    m = tent_sample.update_matrices_plain(fx, fy, r0, r1)
    taps, mode, scale = blur_window(window, n)
    before = blur5_flow.blur5_flow.launches
    got = blur5_flow.blur5_flow(m, taps, mode, scale)
    want = blur5_flow.blur5_flow_plain(m, taps, mode, scale)
    torch.cuda.synchronize()
    assert blur5_flow.blur5_flow.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


FUSED_SHAPES = FB_SHAPES + [(512, 512), (2048, 2048)]
# (shape, window, taps, n_iters, sample_max_shift): every round count at the
# calibrated 33 taps, the tap counts the tile blur treats apart at 2 rounds,
# and the exact gather (R = None)
FUSED_CASES = ([(s, win, 33, it, 5) for s in FUSED_SHAPES for win in BLUR_WINDOWS
                for it in (0, 1, 5)]
               + [(s, win, n, 2, 5) for s in [(47, 61), (512, 512)] for win in BLUR_WINDOWS
                  for n in (1, 3, 129)]
               + [(s, "gaussian", 33, it, None) for s in FUSED_SHAPES for it in (1, 5)])


@pytest.mark.parametrize("shape,window,n,n_iters,R", FUSED_CASES,
                         ids=[f"{s[0]}x{s[1]}-{win}-{n}-{it}-R{R}"
                              for s, win, n, it, R in FUSED_CASES])
def test_fb_fused_kernel_equals_plain(dev, shape, window, n, n_iters, R):
    """The persistent loop at 2x2 to 2048^2 (blocks walking several tiles),
    0 to 5 rounds, 1 to 129 taps, both border rules and a post-scale."""
    r0, r1 = _fb_expansions(dev, shape)
    fx0, fy0 = _fb_flow(dev, shape, 1.0)
    taps, mode, scale = blur_window(window, n)
    before = fb_fused.fb_fused.launches
    got = fb_fused.fb_fused(r0, r1, fx0, fy0, n_iters, taps, mode, scale, R)
    want = fb_fused.fb_fused_plain(r0, r1, fx0, fy0, n_iters, taps, mode, scale, R)
    torch.cuda.synchronize()
    assert fb_fused.fb_fused.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fb_wrappers_reject_bad_tensors(dev):
    r0, r1 = _fb_expansions(dev, (16, 24))
    fx, fy = _fb_flow(dev, (16, 24), 2.0)
    taps, mode, scale = WINDOWS["gaussian"]
    with pytest.raises(ValueError, match="expected shape"):
        tent_sample.update_matrices(fx, fy, r0[:4], r1)
    with pytest.raises(TypeError, match="float32"):
        tent_sample.update_matrices(fx, fy.double(), r0, r1)
    with pytest.raises(ValueError, match="CUDA device"):
        tent_sample.update_matrices(fx, fy.cpu(), r0, r1)
    with pytest.raises(ValueError, match="sample_max_shift"):
        tent_sample.update_matrices(fx, fy, r0, r1, -2)
    m = tent_sample.update_matrices(fx, fy, r0, r1)
    with pytest.raises(ValueError, match="contiguous"):
        blur5_flow.blur5_flow(m.transpose(1, 2).contiguous().transpose(1, 2), taps, mode)
    with pytest.raises(ValueError, match="odd number of taps"):
        blur5_flow.blur5_flow(m, np.ones(4, np.float32), "nearest")
    with pytest.raises(ValueError, match="mode"):
        blur5_flow.blur5_flow(m, taps, "constant")
    with pytest.raises(ValueError, match="expected shape"):
        fb_fused.fb_fused(r0, r1[:, :8], fx, fy, 5, taps, mode)
    with pytest.raises(ValueError, match="n_iters"):
        fb_fused.fb_fused(r0, r1, fx, fy, -1, taps, mode)


@pytest.mark.parametrize("name", FB_NAMES)
def test_fb_pipeline_on_card_matches_cpu(dev, name):
    im1, im2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    counters = (tent_sample.update_matrices, blur5_flow.blur5_flow, warp_tent.warp_pair,
                liu_shen_iter.liu_shen_iterate, fb_fused.fb_fused)
    before = [c.launches for c in counters]
    gu, gv = run_config(name, im1, im2, device=dev)
    cu, cv = run_config(name, im1, im2, device="cpu")
    launched = [c.launches > b for c, b in zip(counters, before)]
    assert launched == [True, True, False, name.startswith("LiuSE_"), False]
    assert aee(gu.cpu().numpy(), gv.cpu().numpy(), cu.numpy(), cv.numpy()) <= 5e-6
