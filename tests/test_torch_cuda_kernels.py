"""The port's Hopper kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import).  The machine with the card needs no JAX, so the
file does not use tests/conftest.py (which imports jax); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Built with -fmad=false, every kernel's flow equals its plain version's bit
for bit; the Liu-Shen error, reduced in another order, agrees to 1e-5
relative, and the Liu-Shen stop comes at the same iteration, also when it
falls inside one of the kernel's launches of T steps.  The HS kernel
is held at every niter mod T (its iterations per launch) and at several T,
and K1 and K4/K5 under every per-side ``edges`` mask and at the tiles and
stripes the sharded solves give them at 2048^2.
The LK build equals its plain version bit for bit, with the symmetric, the
asymmetric and a four-run window; so do the GN loop (px, py and status, on
inputs whose pixels stop at every step from 0 to 5, and on the arguments
``run_config("LK_Fs2_0")`` gives it) and the fused build+GN
(clusters of 8 and of 16, the three windows, a partial last tile).  The four Farneback kernels
(the polynomial expansion, updateMatrices, window blur + solve, the fused
loop) equal their plain versions bit for bit; the expansion from 2x2 to
2048^2 at polyN 5 and 7, on whole images and on stripes whose aprons are a
neighbour's rows, and the FB configurations' replayed flows equal those of
the plain expansion; the fused loop from 2x2 to 2048^2, at 0 to 5 rounds,
1 to 129 taps and with the exact gather.

Every configuration, the README's wrapper call, the fused LK solve
(``lk_dense_solve(impl="fused")``) and the fused Farneback loop on the
level-0 expansions run on the card at 96^2 and 512^2 within AEE 5e-6 of the
port's plain path on the CPU, launching their kernels; the fused Farneback
loop equals ``farneback_solve`` on the card bit for bit, and the 96^2
HS, HS + Liu-Shen, LK and Farneback flows match the golden flows of
tests/golden/ at tests/test_golden.py's bars.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

import opticalflow_ri_tpu_torch as port
from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.models.farneback import (
    _level_plan, _window_blur_spec, farneback_solve, gaussian_blur, poly_expansion,
)
from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve, lk_kernel_inputs
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, build, fb_fused, hs_iter, liu_shen_iter, lk_build, lk_iter, poly_expand,
    tent_sample, warp_tent,
)
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives
from opticalflow_ri_tpu_torch.parallel.sharded_kernel import ls_shard_kernel_supported
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair
from test_torch_kernel_plans import load_kernel_times

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "synthetic96_flows.npz")


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
HS_NITERS = [0, 1, T - 1, T, T + 1, 45, 100, 600]
HS_CASES = [(shape, n) for shape in [(2, 2), (3, 517), (47, 61), (333, 517), (512, 512),
                                     (2048, 2048)]
            for n in HS_NITERS]


def _hs_inputs(dev, shape, seed=0):
    rng = np.random.default_rng(seed)
    fx, fy, ft = hs_derivatives(_rand(rng, shape, 0, 255, dev), _rand(rng, shape, 0, 255, dev))
    return fx, fy, ft, _rand(rng, shape, -2, 2, dev), _rand(rng, shape, -2, 2, dev)


@pytest.mark.parametrize("shape,niter", HS_CASES, ids=[f"{s[0]}x{s[1]}-{n}" for s, n in HS_CASES])
def test_hs_kernel_equals_plain(dev, shape, niter):
    """Every niter mod T (the launches' block depth), 100 and 600 as the HS
    and PyHSchunck configs run them, and shapes smaller than the halo."""
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


@pytest.mark.parametrize("shape", [(2, 3), (47, 61), (333, 517), (512, 512)])
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
_TOP, _BOT, _LEFT, _RIGHT = hs_iter.TOP, hs_iter.BOTTOM, hs_iter.LEFT, hs_iter.RIGHT
# every mask at 47x61 and 333x517; then the sharded solves' own calls at
# 2048^2: the (1, 2, 2) mesh's 1024^2 tiles and the (2, 1, 2) mesh's
# 2048 x 1024 ones, each with a T-deep apron on its interior sides, and the
# whole image with every side an apron edge
HS_MASKED = ([(shape, edges) for shape in [(47, 61), (333, 517)] for edges in EDGES]
             + [((1024 + T, 1024 + T), e) for e in (_TOP | _LEFT, _TOP | _RIGHT, _BOT | _LEFT,
                                                     _BOT | _RIGHT)]
             + [((2048, 1024 + T), e) for e in (_TOP | _BOT | _LEFT, _TOP | _BOT | _RIGHT)]
             + [((2048, 2048), 0)])


@pytest.mark.parametrize("shape,edges", HS_MASKED,
                         ids=[f"{s[0]}x{s[1]}-{e}" for s, e in HS_MASKED])
def test_hs_kernel_masked_equals_plain(dev, shape, edges):
    """The per-side border mask of a sharded tile: the whole array, apron
    edges included, bit for bit, at 1, T-1 and T iterations and the last
    launch of a 100-iteration solve (100 mod T)."""
    fx, fy, ft, u0, v0 = _hs_inputs(dev, shape, seed=5)
    for niter in sorted({1, T - 1, T, 100 % T or T}):
        got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, niter, edges)
        want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter, edges)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# the rows-sharded solve's block depth on the (1, 4, 1) mesh's 512-row
# stripes of 2048^2
T_STRIPE = next(t for t in (16, 8, 4) if ls_shard_kernel_supported(512, 2048, t))
# every mask at 47x61 and 333x517; then the (1, 4, 1) mesh's stripes at
# 2048^2 (a T_STRIPE-row apron on each interior side: the top, an inner and
# the bottom stripe) and the whole image with every side an apron edge
LS_MASKED = ([(shape, edges) for shape in [(47, 61), (333, 517)] for edges in EDGES]
             + [((512 + T_STRIPE, 2048), _TOP | _LEFT | _RIGHT),
                ((512 + 2 * T_STRIPE, 2048), _LEFT | _RIGHT),
                ((512 + T_STRIPE, 2048), _BOT | _LEFT | _RIGHT), ((2048, 2048), 0)])


@pytest.mark.parametrize("shape,edges", LS_MASKED,
                         ids=[f"{s[0]}x{s[1]}-{e}" for s, e in LS_MASKED])
def test_ls_kernel_masked_equals_plain(dev, shape, edges):
    """The mask with the stop (tol 0: 1 and T steps) and without it
    (2T + 1 steps, err NaN, k = max_iter); at 2048^2 also the sharded
    solve's calls without the stop: T_STRIPE - 1 steps then 1, and 60."""
    fields, u0, v0 = _ls_inputs(np.random.default_rng(6), shape, dev)
    runs = [(1, True), (T_LS, True), (2 * T_LS + 1, False)]
    if shape[1] == 2048:
        runs += [(T_STRIPE - 1, False), (1, False), (60, False)]
    for n, stop in runs:
        got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, n, 0.0, edges, stop)
        want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, n, 0.0, edges, stop)
        torch.cuda.synchronize()
        assert int(got[3]) == int(want[3]) == n
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(torch.isnan(got[2])) == (not stop)


# ---------------------------------------------------------------- the main path

def _wrapper(a, b, device):
    """The README's wrapper call: HS alpha 21, 600 iterations, sigma 3.4."""
    return port.GenericPyramidalOpticalFlowWrapper(
        port.HSOpticalFlowAlgoAdapter([21.0], 600), filter_sigma=3.4,
        device=device).calculateFlow(a, b)


def _lk_fused_solve(a, b, device):
    """The fused LK kernel's entry: one calibrated LK solve from zero flow."""
    a, b = (torch.as_tensor(x, device=device) for x in (a, b))
    z = torch.zeros(a.shape, device=device)
    return lk_dense_solve(a, b, z, z, impl="fused")[:2]


def _fb_fused_solve(a, b, device):
    """The fused Farneback kernel's entry: the calibrated rounds (window 33
    Gaussian, 5 rounds, polyN 7, polySigma 1.5) from zero flow on the
    level-0 expansions, i.e. ``farneback_solve`` at one level."""
    a, b = (torch.as_tensor(x, device=device) for x in (a, b))
    lvl = _level_plan(a.shape[0], a.shape[1], 0.5, 0)[0]
    r0, r1 = (poly_expansion(gaussian_blur(im, lvl["smooth"], lvl["sigma"]), 7, 1.5)
              .contiguous() for im in (a, b))
    z = torch.zeros(a.shape, device=device)
    taps, mode, scale = WINDOWS["gaussian"]
    return fb_fused.fb_fused(r0, r1, z, z, 5, taps, mode, scale)


# the entries the pipeline tests run beside the configurations: the wrapper,
# the fused kernels' solves, and the four two-level pyramids of the golden
# flows (tests/test_golden.py), run at 96^2 only
ENTRIES = {
    "wrapper": _wrapper,
    "lk_dense_solve_fused": _lk_fused_solve,
    "fb_fused_solve": _fb_fused_solve,
    "golden_hs": lambda a, b, device: port.generic_pyramidal_optical_flow(
        a, b, 3.4, port.HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1, device=device),
    "golden_hs_ls": lambda a, b, device: port.generic_pyramidal_optical_flow(
        a, b, 3.4, port.HSOpticalFlowAlgoAdapter([21.0, 45.0], 60), 2, 1, FILTER_OPT=0.48,
        optionalOFlowAlgoAdapter=port.LiuShenOpticalFlowAlgoAdapter(5), device=device),
    "golden_lk": lambda a, b, device: port.generic_pyramidal_optical_flow(
        a, b, 2.0, port.DenseLucasKanadeAdapter(), 2, 1, FILTER_OPT=0.48, warping=False,
        device=device),
    "golden_fb": lambda a, b, device: port.generic_pyramidal_optical_flow(
        a, b, 0.0, port.FarnebackAdapter(), 2, 1, device=device),
}


def _cases(names):
    """(name, size): every name at 96^2, all but the golden ones at 512^2."""
    cases = [(n, 96) for n in names] + [(n, 512) for n in names if not n.startswith("golden")]
    return pytest.mark.parametrize("name,size", cases, ids=[f"{n}-{s}" for n, s in cases])


def _card_against_cpu(dev, name, size):
    """The card's flows of ``name`` on the particle pair of size^2, held
    within AEE 5e-6 of the CPU plain path's; at 96^2 a golden entry's also
    against its golden flows, at tests/test_golden.py's bars."""
    im1, im2, _, _ = particle_image_pair(shape=(size, size), seed=3, max_disp=2.5)
    run = ENTRIES.get(name) or (lambda a, b, device: run_config(name, a, b, device=device))
    gu, gv = (t.cpu().numpy() for t in run(im1, im2, dev))
    cu, cv = (t.numpy() for t in run(im1, im2, "cpu"))
    assert gu.shape == (size, size) and gu.dtype == np.float32
    assert np.isfinite(gu).all() and np.isfinite(gv).all()
    assert aee(gu, gv, cu, cv) <= 5e-6
    if name.startswith("golden"):
        key = name[len("golden_"):]
        want_u, want_v = (np.load(GOLDEN)[f"{key}_{c}"] for c in "uv")
        if key == "lk":  # the bulk check: early exits amplify noise on lone pixels
            assert ((np.abs(gu - want_u) < 1e-2) & (np.abs(gv - want_v) < 1e-2)).mean() > 0.99
        else:
            assert aee(gu, gv, want_u, want_v) < (2e-3 if key == "fb" else 1e-3)
    return gu, gv


@_cases(["HS_Fs0_0", "HS_Fs3_4", "PyHSchunck_Fs3_4", "HS_Fs3_4_PyrLvls2",
         "PyHSchunck_Fs3_4_PyrLvls2", "wrapper", "golden_hs"])
def test_pipeline_on_card_matches_cpu(dev, name, size):
    hs_before, warp_before = hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches
    _card_against_cpu(dev, name, size)
    assert hs_iter.hs_iterate.launches > hs_before
    two_levels = name.endswith("PyrLvls2") or name == "golden_hs"
    assert (warp_tent.warp_pair.launches > warp_before) == two_levels


@_cases(["LiuSE_HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "LiuSE_LK_Fs2_0_PyrLvls2",
         "LiuSE_FB_Fs0_0_PyrLvls2", "golden_hs_ls"])
def test_liu_shen_pipeline_on_card_matches_cpu(dev, name, size):
    ls_before, warp_before = liu_shen_iter.liu_shen_iterate.launches, warp_tent.warp_pair.launches
    hs_before = hs_iter.hs_iterate.launches
    _card_against_cpu(dev, name, size)
    assert liu_shen_iter.liu_shen_iterate.launches > ls_before
    assert warp_tent.warp_pair.launches > warp_before
    assert (hs_iter.hs_iterate.launches > hs_before) == ("PyHSchunck" in name or "golden" in name)


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


@pytest.mark.parametrize("shape", [(2, 2), (47, 61), (333, 517), (512, 512), (2048, 2048)])
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
    configs' smooth input); 'configs': what ``lk_gn_iterate`` receives in
    one ``run_config("LK_Fs2_0")`` on the particle pair; or 'stops': a flat
    band (singular windows), some origins beyond the bail bounds, the rest
    |d| <= 4, so that pixels end their loop at every step from 0 to 5."""
    if case == "configs":
        im1, im2, _, _ = particle_image_pair(shape=shape, seed=0)
        return load_kernel_times().capture_lk_args(
            run_config, lk_build, lk_iter, "LK_Fs2_0", torch.tensor(im1, device=dev),
            torch.tensor(im2, device=dev))[1][:10]
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


@pytest.mark.parametrize("shape", [(47, 61), (333, 517), (512, 512), (2048, 2048)])
@pytest.mark.parametrize("case", ["calibrated", "wild", "smooth", "configs", "stops"])
def test_lk_gn_kernel_exits_equal_plain(dev, shape, case):
    """The per-pixel exit, n_iter 0, 1, 5; on the 'stops' input pixels end
    their loop at every step from 0 to 5 (``gn_exit``'s count)."""
    args = _lk_gn_input(dev, shape, case)
    if case == "stops":
        steps = load_kernel_times().gn_exit(lk_iter, *args, 5, 5, 13)[3]
        assert bool((torch.bincount(steps.flatten(), minlength=6) > 0).all())
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


LARGE_FUSED = [((2048, 2048), 5, (0, 0, 0, 0), 4.0), ((333, 517), 6, (0, 0, 0, 0), 4.0),
               ((333, 517), 7, (0, 0, 0, 0), 4.0), ((2048, 2048), 5, (1, 0, 0, 1), 20.0),
               ((2048, 2048), 5, "four_runs", 20.0), ((512, 512), 6, (0, 0, 0, 0), 20.0)]


@pytest.mark.parametrize("shape,R,asym,dmax", LARGE_FUSED,
                         ids=["2048-R5", "333x517-R6", "333x517-R7", "2048-R5-asym",
                              "2048-R5-four_runs", "512-R6"])
def test_lk_fused_kernel_large_and_clusters_equal_plain(dev, shape, R, asym, dmax):
    """2048^2 with the three windows, and clusters of 16 blocks (R = 6 and 7
    need them)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    u0, v0 = (torch.tensor(rng.uniform(-dmax, dmax, shape).astype(np.float32), device=dev)
              for _ in range(2))
    slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
        torch.tensor(a, device=dev), torch.tensor(b, device=dev), u0, v0,
        asym=asym if asym != "four_runs" else (0, 0, 0, 0), max_shift=R)
    if asym == "four_runs":
        runs_y, runs_x = FOUR_RUNS_Y, FOUR_RUNS_X
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


@_cases(LK_NAMES + ["lk_dense_solve_fused", "golden_lk"])
def test_lk_pipeline_on_card_matches_cpu(dev, name, size):
    counters = (lk_build.lk_build_planes, lk_iter.lk_gn_iterate, lk_iter.lk_fused,
                warp_tent.warp_pair, liu_shen_iter.liu_shen_iterate)
    before = [c.launches for c in counters]
    _card_against_cpu(dev, name, size)
    launched = [c.launches > b for c, b in zip(counters, before)]
    fused = name == "lk_dense_solve_fused"
    assert launched == [not fused, not fused, fused, False, name.startswith("LiuSE_")]


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


POLY_SHAPES = [(2, 2), (5, 7), (47, 61), (333, 517), (512, 512), (1024, 1024), (2048, 2048)]


def _poly_source(dev, shape, n, form, seed=7):
    """(srcp, the whole image's plain expansion at srcp's rows): the image
    with the replicate rule's n rows above and below it ("whole"), or an
    interior stripe of a taller image with n rows of the neighbours' image
    above and below it ("stripe")."""
    rng = np.random.default_rng(seed + n)
    m = 0 if form == "whole" else n + 3
    im = _rand(rng, (shape[0] + 2 * m, shape[1]), 0, 255, dev)
    padded = pad2d(im, ((n, n), (0, 0)), "nearest")
    return padded[m:m + shape[0] + 2 * n].contiguous(), padded


@pytest.mark.parametrize("shape", POLY_SHAPES)
@pytest.mark.parametrize("n", [5, 7])
@pytest.mark.parametrize("sigma", [1.1, 1.5])
@pytest.mark.parametrize("form", ["whole", "stripe"])
def test_poly_expand_kernel_equals_plain(dev, shape, n, sigma, form):
    srcp, padded = _poly_source(dev, shape, n, form)
    before = poly_expand.poly_expand.launches
    got = poly_expand.poly_expand(srcp, n, sigma)
    want = poly_expand.poly_expand_plain(srcp, n, sigma)
    torch.cuda.synchronize()
    assert poly_expand.poly_expand.launches == before + 1
    assert got.shape == (5, *shape) and got.is_contiguous()
    assert torch.equal(got, want)
    if form == "stripe":  # the stripe's rows of the whole image's expansion
        m = n + 3
        whole = poly_expand.poly_expand_plain(padded, n, sigma)
        assert torch.equal(got, whole[:, m:m + shape[0]])


def test_poly_expand_launches_count_at_capture_only(dev):
    """The wrapper counts its calls: a CUDA graph's capture counts one, its
    replays none, and each replay writes the expansion again."""
    srcp, _ = _poly_source(dev, (333, 517), 7, "whole")
    want = poly_expand.poly_expand_plain(srcp, 7, 1.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        poly_expand.poly_expand(srcp, 7, 1.5)
    torch.cuda.current_stream().wait_stream(side)
    before = poly_expand.poly_expand.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = poly_expand.poly_expand(srcp, 7, 1.5)
    assert poly_expand.poly_expand.launches == before + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert poly_expand.poly_expand.launches == before + 1


def test_poly_expand_rejects_bad_tensors(dev):
    srcp, _ = _poly_source(dev, (16, 24), 7, "whole")
    with pytest.raises(ValueError, match="contiguous"):
        poly_expand.poly_expand(srcp.t().contiguous().t(), 7, 1.5)
    with pytest.raises(TypeError, match="float32"):
        poly_expand.poly_expand(srcp.double(), 7, 1.5)
    with pytest.raises(ValueError, match="H \\+ 2n, W"):
        poly_expand.poly_expand(srcp[None], 7, 1.5)
    with pytest.raises(ValueError, match="odd tap count"):
        poly_expand.poly_expand(srcp, 8, 1.5)
    with pytest.raises(ValueError, match="at least 15 rows"):
        poly_expand.poly_expand(srcp[:14], 7, 1.5)


@pytest.mark.parametrize("shape", FB_SHAPES + [(512, 512), (2048, 2048)])
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


FUSED_SHAPES = FB_SHAPES + [(3, 517), (512, 512), (2048, 2048)]
# (shape, window, taps, n_iters, sample_max_shift): every round count at the
# calibrated 33 taps, the tap counts the tile blur treats apart at 2 rounds,
# and the exact gather (R = None)
FUSED_CASES = ([(s, win, 33, it, 5) for s in FUSED_SHAPES for win in BLUR_WINDOWS
                for it in (0, 1, 2, 5)]
               + [(s, win, n, 2, 5) for s in FUSED_SHAPES for win in BLUR_WINDOWS
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


@_cases(FB_NAMES + ["fb_fused_solve", "golden_fb"])
def test_fb_pipeline_on_card_matches_cpu(dev, name, size):
    """The fused loop's entry also equals ``farneback_solve`` on the card
    bit for bit (the same rounds)."""
    counters = (poly_expand.poly_expand, tent_sample.update_matrices, blur5_flow.blur5_flow,
                warp_tent.warp_pair, liu_shen_iter.liu_shen_iterate, fb_fused.fb_fused)
    before = [c.launches for c in counters]
    gu, gv = _card_against_cpu(dev, name, size)
    launched = [c.launches > b for c, b in zip(counters, before)]
    fused = name == "fb_fused_solve"
    assert launched == [True, not fused, not fused, False, name.startswith("LiuSE_"), fused]
    if fused:
        im1, im2 = (torch.as_tensor(im, device=dev)
                    for im in particle_image_pair(shape=(size, size), seed=3, max_disp=2.5)[:2])
        z = torch.zeros((size, size), device=dev)
        want = farneback_solve(im1, im2, z, z)
        assert np.array_equal(gu, want[0].cpu().numpy())
        assert np.array_equal(gv, want[1].cpu().numpy())


@pytest.mark.parametrize("name", FB_NAMES)
def test_fb_graph_flows_equal_plain_expansion_flows(dev, name, monkeypatch):
    """Each FB configuration replayed as one CUDA graph, the expansion
    kernel inside it, gives the flows of the eager run with the plain
    expansion (the PyTorch op chain) bit for bit; the expansions a run
    launches (two frames a solver level) are counted at the capture, never
    at a replay."""
    from opticalflow_ri_tpu_torch.compile import CompiledPipeline

    im1, im2, _, _ = particle_image_pair(shape=(96, 80), seed=4, max_disp=2.5)
    im1, im2 = torch.as_tensor(im1, device=dev), torch.as_tensor(im2, device=dev)
    counter = poly_expand.poly_expand
    before = counter.launches
    run_config(name, im1, im2)
    per_run = counter.launches - before
    assert per_run == {"FB_Fs0_0": 2, "FB_Fs0_0_PyrLvls2": 4}.get(name, per_run) > 0
    fn = CompiledPipeline(name)
    try:
        fn.warm_up(im1, im2)
        before = counter.launches
        got = fn(im1, im2)  # the capture, then a replay
        assert counter.launches == before + per_run
        again = fn(im1, im2)
        torch.cuda.synchronize()
        assert counter.launches == before + per_run
    finally:
        fn.release()
    monkeypatch.setattr(poly_expand, "poly_expand", poly_expand.poly_expand_plain)
    want = run_config(name, im1, im2)
    for flows in (got, again):
        assert all(torch.equal(g, w) for g, w in zip(flows, want))
