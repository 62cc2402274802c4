"""The port's multi-GPU layer on the card: a one-rank NCCL process group in
this process.

Marked ``cuda``; skips without a CUDA device.  Run on the machine with the
card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel.py -q

On one rank every side of the tile is the image's border, so the kernel
paths run the single-device kernels on the whole image in T-iteration
launches: their u, v equal the single-device port's bit for bit, and err
agrees to 1e-6 relative; the rows-sharded LK and Farneback equal
``lk_dense_solve`` and ``farneback_solve`` bit for bit.  The sharded modes
of K7 (global rows), K9 (stripe mode with each apron) and K12 (the four y
masks) equal their plain versions on stripes bit for bit.  K3's
caller-padded mode equals its plain version and the whole-image kernel
cropped, bit for bit; route 2 of every configuration on one rank is held
to ``run_config`` (AEE <= 5e-6), through ``auto_sharded_pipeline``, which
replays it as a CUDA graph.  The sharded graph replays equal
``sharded_pipeline_fn`` bit for bit; a gloo group refuses CUDA tiles (in a
child process, which can make its own process group); the gated K4/K5
equals its plain version.  (Four ranks on one card, over gloo with the
halos staged through host memory, are driven by ``chip_smoke.py``'s
parallel phase.)
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.models import farneback as fb
from opticalflow_ri_tpu_torch.models import lucas_kanade as lk
from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve
from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, hs_iter, liu_shen_iter, lk_build, lk_iter, tent_sample,
)
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from opticalflow_ri_tpu_torch.parallel import distributed, make_mesh

    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    distributed.initialize(f"file://{rdv}", 1, 0)
    assert dist.get_backend() == "nccl"
    distributed.initialize()  # a no-op
    yield make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair():
    return [torch.as_tensor(im, device="cuda")
            for im in particle_image_pair(shape=(333, 517), seed=0)[:2]]


def test_hs_solve_sharded_kernel_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import hs_solve_sharded

    z = torch.zeros_like(pair[0])
    before = hs_iter.hs_iterate.launches
    u, v, err = hs_solve_sharded(nccl_mesh, *pair, 21.0, 45, z, z)
    assert hs_iter.hs_iterate.launches - before == -(-45 // hs_iter.STEPS_PER_LAUNCH)
    ur, vr, er = hs_solve(*pair, 21.0, 45, z, z)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    np.testing.assert_allclose(float(err), float(er), rtol=1e-6)


def test_liu_shen_solve_sharded_kernel_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import liu_shen_solve_sharded

    z = torch.zeros_like(pair[0])
    u, v, err = liu_shen_solve_sharded(nccl_mesh, *pair, 10.0, z, z, max_iter=60, tol=0.0)
    a, b = pair
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    ur, vr, er, k = liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, 0.0)
    assert int(k) == 60
    assert torch.equal(u, ur) and torch.equal(v, vr)
    np.testing.assert_allclose(float(err), float(er), rtol=1e-6)


def test_auto_route1_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.compile import compiled_pipeline
    from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline

    assert auto_sharded_pipeline("HS_Fs3_4", nccl_mesh) is compiled_pipeline("HS_Fs3_4")
    u, v = auto_sharded_pipeline("HS_Fs3_4", nccl_mesh, _force_sharded=True)(*pair)
    ur, vr = run_config("HS_Fs3_4", *pair)
    assert torch.equal(u, ur) and torch.equal(v, vr)


def test_batched_pipeline_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
    from opticalflow_ri_tpu_torch.parallel import batched_hs_pipeline

    s1, s2 = (torch.stack([x, 0.5 * x]) for x in pair)
    u, v, err = batched_hs_pipeline(nccl_mesh, s1, s2, niter=20)
    for k in range(2):
        f = [gaussian_filter_px(s[k], 3.4, 3) for s in (s1, s2)]
        z = torch.zeros_like(f[0])
        ur, vr, er = hs_solve(*f, 21.0, 20, z, z)
        assert torch.equal(u[k], ur) and torch.equal(v[k], vr)
        np.testing.assert_allclose(float(err[k]), float(er), rtol=1e-6)


def test_gather_global_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import distributed

    g = distributed.gather_global(nccl_mesh, pair[0], ("y", "x"))
    assert torch.equal(g, pair[0])


def test_lk_solve_sharded_kernel_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import lk_solve_sharded_kernel

    z = torch.zeros_like(pair[0])
    before = lk_build.lk_build_planes.launches, lk_iter.lk_gn_iterate.launches
    got = lk_solve_sharded_kernel(nccl_mesh, *pair, z, z)
    assert (lk_build.lk_build_planes.launches - before[0],
            lk_iter.lk_gn_iterate.launches - before[1]) == (1, 1)
    assert all(torch.equal(g, w) for g, w in zip(got, lk.lk_dense_solve(*pair, z, z)))


@pytest.mark.parametrize("use_gaussian", [True, False], ids=["gaussian", "box"])
def test_farneback_solve_sharded_on_one_nccl_rank(nccl_mesh, pair, use_gaussian):
    from opticalflow_ri_tpu_torch.parallel import farneback_solve_sharded

    z = torch.zeros_like(pair[0])
    before = tent_sample.update_matrices.launches, blur5_flow.blur5_flow.launches
    got = farneback_solve_sharded(nccl_mesh, *pair, z, z, use_gaussian=use_gaussian)
    assert (tent_sample.update_matrices.launches - before[0],
            blur5_flow.blur5_flow.launches - before[1]) == (5, 5)
    want = fb.farneback_solve(*pair, z, z, use_gaussian=use_gaussian)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# (row0, rows) of the stripes of a 3 x 111-row image: top, interior, bottom
STRIPES = [(0, 111), (111, 111), (222, 111)]


@pytest.mark.parametrize("row0,rows", STRIPES, ids=["top", "interior", "bottom"])
def test_lk_gn_global_rows_equal_plain(row0, rows):
    """K7 in global rows on an LK stripe (slab and fields from the image
    padded as the exchange pads it), some origins past the image's bottom."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = (3 * rows, 173)
    rng = np.random.default_rng(row0)
    a = rng.uniform(0, 255, img).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, img).astype(np.float32)
    u0, v0 = (rng.uniform(-4, 4, img).astype(np.float32) for _ in range(2))
    v0[-8:, ::3] = 14.5
    pad = lk.lk_pad(5)
    ap, bp = (pad2d(torch.tensor(x, device="cuda"), pad, "nearest")[row0 : row0 + rows + 2 * pad]
              for x in (a, b))
    flows = [torch.tensor(x[row0 : row0 + rows], device="cuda") for x in (u0, v0)]
    slab, g_pair, fields, runs_y, runs_x = lk.lk_kernel_inputs_padded(ap, bp, *flows, 13,
                                                                      (0, 0, 0, 0), 5, row0)
    t = lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)
    for n in (0, 1, 5):
        got = lk_iter.lk_gn_iterate(*t, *fields, n, 5, 13, row0=row0, img_h=img[0], img_w=img[1])
        want = lk_iter.lk_gn_iterate_plain(*t, *fields, n, 5, 13, row0=row0, img_h=img[0],
                                           img_w=img[1])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), n


@pytest.mark.parametrize("row0,rows", STRIPES + [(0, 333)],
                         ids=["top", "interior", "bottom", "whole"])
def test_update_matrices_stripe_and_blur_masks_equal_plain(row0, rows):
    """K9 in stripe mode (R-row aprons on the interior sides) and K12 under
    the stripe's y mask, both windows, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img_h, w, R = 333, 173, 5
    im1, im2, _, _ = particle_image_pair(shape=(img_h, w), seed=3)
    r0, r1 = (fb.poly_expansion(torch.tensor(im, device="cuda"), 7, 1.5).contiguous()
              for im in (im1, im2))
    rng = np.random.default_rng(rows + row0)
    fx, fy = (torch.tensor(rng.uniform(-4, 4, (img_h, w)).astype(np.float32), device="cuda")
              for _ in range(2))
    a_top, a_bot = (R if row0 else 0), (R if row0 + rows < img_h else 0)
    sl = slice(row0, row0 + rows)
    args = (fx[sl], fy[sl], r0[:, sl].contiguous(),
            r1[:, row0 - a_top : row0 + rows + a_bot].contiguous(), R)
    kw = dict(row0=row0, img_rows=img_h, apron=(a_top, a_bot))
    assert torch.equal(tent_sample.update_matrices(*args, **kw),
                       tent_sample.update_matrices_plain(*args, **kw))
    m = tent_sample.update_matrices(fx, fy, r0, r1)
    edges = (hs_iter.TOP if row0 == 0 else 0) | (hs_iter.BOTTOM if row0 + rows == img_h else 0)
    for use_gaussian in (True, False):
        taps, mode, scale = fb._window_blur_spec(33, use_gaussian)
        half = len(taps) // 2
        lo = row0 - (0 if edges & hs_iter.TOP else half)
        hi = row0 + rows + (0 if edges & hs_iter.BOTTOM else half)
        mm = m[:, lo:hi].contiguous()
        got = blur5_flow.blur5_flow(mm, taps, mode, scale, edges)
        want = blur5_flow.blur5_flow_plain(mm, taps, mode, scale, edges)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), use_gaussian


# ---------------------------------------------------------------------------
# the sharded pyramid: K3's caller-padded mode and route 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dmax", [4.0, 12.0], ids=["calibrated", "wild"])
def test_warp_padded_mode_equals_whole_image_cropped(dmax):
    """K3 in its caller-padded mode (an 8-cell "nearest" apron) against its
    plain version and against the whole-image kernel cropped to the tile,
    bit for bit, under all 16 combinations of border and interior sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    from opticalflow_ri_tpu_torch.ops.cuda import warp_tent

    h, w, a = 333, 517, 8
    rng = np.random.default_rng(int(dmax))
    ims = [torch.tensor(rng.uniform(0, 255, (h, w)).astype(np.float32), device="cuda")
           for _ in range(2)]
    flows = [torch.tensor(rng.uniform(-dmax, dmax, (h, w)).astype(np.float32), device="cuda")
             for _ in range(4)]
    whole = warp_tent.warp_pair(*ims, *flows)
    padded = [pad2d(im, a, "nearest") for im in ims]
    for top, bottom, left, right in itertools.product((True, False), repeat=4):
        r0, r1 = (0 if top else 101), (h if bottom else h - 77)
        c0, c1 = (0 if left else 130), (w if right else w - 200)
        tiles = [p[r0:r1 + 2 * a, c0:c1 + 2 * a].contiguous() for p in padded]
        cut = [f[r0:r1, c0:c1].contiguous() for f in flows]
        tile = dict(apron=a, row0=r0, col0=c0, img_h=h, img_w=w)
        got = warp_tent.warp_pair(*tiles, *cut, **tile)
        plain = warp_tent.warp_pair_plain(*tiles, *cut, **tile)
        for g, p, want in zip(got, plain, whole):
            assert torch.equal(g, p) and torch.equal(g, want[r0:r1, c0:c1])


ROUTE2 = ("PyHSchunck_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "denseLK_Fs2_0",
          "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2", "Farneback_Fs0_0",
          "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2", "HS_Fs3_4_PyrLvls2",
          "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0", "LK_Fs2_0_PyrLvls2", "LiuSE_LK_Fs2_0_PyrLvls2",
          "FB_Fs0_0", "FB_Fs0_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2")


@pytest.mark.parametrize("name", ROUTE2)
def test_auto_route2_on_one_nccl_rank(nccl_mesh, name):
    """Route 2 (``_force_sharded=True``) on a one-rank mesh against
    ``run_config`` at 256 x 384: AEE <= 5e-6."""
    from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline

    pair = [torch.as_tensor(im, device="cuda")
            for im in particle_image_pair(shape=(256, 384), seed=0)[:2]]
    u, v = auto_sharded_pipeline(name, nccl_mesh, _force_sharded=True)(*pair)
    ur, vr = run_config(name, *pair)
    assert float(torch.hypot(u - ur, v - vr).mean()) <= 5e-6


def test_farneback_two_levels_on_one_nccl_rank(nccl_mesh, pair):
    from opticalflow_ri_tpu_torch.parallel import farneback_solve_sharded

    z = torch.zeros_like(pair[0])
    got = farneback_solve_sharded(nccl_mesh, *pair, z, z, pyr_levels=2)
    want = fb.farneback_solve(*pair, z, z, pyr_levels=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the sharded pipeline as one CUDA graph per tile shape
# ---------------------------------------------------------------------------

GRAPHED = ("HS_Fs3_4", "HS_Fs0_0", "PyHSchunck_Fs3_4", "HS_Fs3_4_PyrLvls2",
           "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0_PyrLvls2", "Farneback_Fs0_0_PyrLvls2")


@pytest.mark.parametrize("name", GRAPHED)
def test_sharded_replay_equals_eager_on_one_nccl_rank(nccl_mesh, name):
    """``auto_sharded_pipeline`` replays one graph per tile shape, bit for
    bit ``sharded_pipeline_fn`` on two pairs; the second pair launches no
    kernel from the host.  The capture itself shows that the path reads no
    tensor on the host: such a read raises while the stream captures."""
    from opticalflow_ri_tpu_torch.parallel import auto_sharded_pipeline, sharded_pipeline_fn

    pairs = [[torch.as_tensor(im, device="cuda")
              for im in particle_image_pair(shape=(256, 384), seed=s)[:2]] for s in (0, 1)]
    fn = auto_sharded_pipeline(name, nccl_mesh, _force_sharded=True)
    eager = sharded_pipeline_fn(name, nccl_mesh)
    assert torch.equal(torch.stack(fn(*pairs[0])), torch.stack(eager(*pairs[0])))
    before = (hs_iter.hs_iterate.launches, liu_shen_iter.liu_shen_iterate.launches)
    got = fn(*pairs[1])
    assert (hs_iter.hs_iterate.launches, liu_shen_iter.liu_shen_iterate.launches) == before
    assert torch.equal(torch.stack(got), torch.stack(eager(*pairs[1])))
    fn.release()


_GLOO_CHILD = r"""
import os, sys, torch
from opticalflow_ri_tpu_torch.parallel import (
    auto_sharded_pipeline, distributed, halo, make_mesh, sharded_pipeline_fn)
from opticalflow_ri_tpu_torch.parallel.mesh import axis_group
distributed.initialize(sys.argv[1], 1, 0, backend="gloo")
mesh = make_mesh(shape=(1, 1, 1))
a, b = (torch.rand((128, 128), device="cuda") * 255 for _ in range(2))
sharded_pipeline_fn("HS_Fs3_4", mesh)(a, b)            # the eager path runs
try:
    auto_sharded_pipeline("HS_Fs3_4", mesh, _force_sharded=True)(a, b)
    sys.exit("no ValueError on CUDA tiles over gloo")
except ValueError as err:
    assert "sharded_pipeline_fn" in str(err), err
g = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(g):
        halo._staged(axis_group(mesh, "y"), a)
    sys.exit("staging through host memory was not refused during a capture")
except RuntimeError as err:
    assert "capture" in str(err), err
torch.distributed.destroy_process_group()
print("GLOO_OK")
"""


def test_gloo_group_refuses_cuda_tiles(tmp_path):
    """On a gloo group ``auto_sharded_pipeline`` raises on CUDA tiles,
    naming ``sharded_pipeline_fn``, which runs them; staging a CUDA tile
    through host memory raises while a graph is being captured."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = __import__("os").path.dirname(__import__("os").path.dirname(__file__))
    run = subprocess.run([sys.executable, "-c", _GLOO_CHILD, f"file://{tmp_path / 'rdv'}"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "GLOO_OK" in run.stdout, run.stderr[-3000:]


@pytest.mark.parametrize("stop", [True, False], ids=["stop", "no_stop"])
@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("shape,edges", [((47, 61), 15), ((333, 517), 15), ((144, 256), 0),
                                         ((144, 256), hs_iter.TOP)])
def test_liu_shen_gate_equals_plain(shape, edges, gate, stop):
    """K4/K5 with a device gate: bit for bit its plain version (u, v, k;
    err too with the stop), 0 giving (u0, v0, 0, 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    a, b = (torch.as_tensor(rng.uniform(1, 255, shape).astype(np.float32), device="cuda")
            for _ in range(2))
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    u0, v0 = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
              for _ in range(2))
    g = torch.tensor(gate, dtype=torch.int32, device="cuda")
    got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, 20, 1e-7, edges, stop, gate=g)
    want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, 20, 1e-7, edges, stop,
                                                gate=g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[3]) == int(want[3]) == (0 if gate == 0 else 20 if not stop else int(got[3]))
    if gate == 0:
        assert torch.equal(got[0], u0) and float(got[2]) == 0.0
    elif stop:
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
