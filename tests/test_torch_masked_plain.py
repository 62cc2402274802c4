"""The per-side ``edges`` masks of the HS and Liu-Shen plain versions (what
the K1 and K4/K5 kernels do on a rank's tile of a sharded image), on the CPU.

With every side the image's border the masked formulation is today's
iteration, bit for bit.  With any mask, a tile cut from a whole image and
padded by T cells of its neighbours' data on each side the mask leaves out
(an apron edge) takes the whole-image iteration exactly in the cells it
owns, for up to T iterations: the wrong values beyond an apron edge creep
one cell an iteration and stay in the cropped apron.
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, liu_shen_iter
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.stencil import hs_avg3x3, hs_derivatives

ALL = hs_iter.ALL
MASKS = list(range(16))
T = 5


def _rand(rng, shape, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["mirror", "nearest"])
def test_pad1_edges_all_equals_pad2d(mode):
    x = _rand(np.random.default_rng(0), (7, 9), -1, 1)
    assert torch.equal(hs_iter.pad1_edges(x, ALL, mode), pad2d(x, 1, mode))


@pytest.mark.parametrize("edges", MASKS)
def test_pad1_edges_zero_beyond_apron_sides(edges):
    x = _rand(np.random.default_rng(1), (6, 8), 1, 2)
    p = hs_iter.pad1_edges(x, edges, "nearest")
    for bit, line in ((hs_iter.TOP, p[0, 1:-1]), (hs_iter.BOTTOM, p[-1, 1:-1]),
                      (hs_iter.LEFT, p[1:-1, 0]), (hs_iter.RIGHT, p[1:-1, -1])):
        assert bool((line != 0).all()) == bool(edges & bit)


def test_hs_masked_formulation_at_all_edges_equals_todays():
    """The masked average (the per-side pad, then the padded stencil) with
    every bit set equals the unmasked mirror average, ``hs_avg3x3``, bit for
    bit."""
    rng = np.random.default_rng(2)
    fx, fy, ft = hs_derivatives(_rand(rng, (33, 41), 0, 255), _rand(rng, (33, 41), 0, 255))
    u0, v0 = _rand(rng, (33, 41), -2, 2), _rand(rng, (33, 41), -2, 2)
    got = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, 7, ALL)
    saved = hs_iter.hs_avg3x3_edges
    try:
        hs_iter.hs_avg3x3_edges = lambda x, e: hs_avg3x3(x, "mirror")
        want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, 7)
    finally:
        hs_iter.hs_avg3x3_edges = saved
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ls_masked_formulation_at_all_edges_equals_todays():
    """The Liu-Shen step with every bit set equals the step on the unmasked
    nearest pad, ``pad2d(z, 1, "nearest")``, bit for bit."""
    rng = np.random.default_rng(3)
    a, b = _rand(rng, (21, 30), 1, 255), _rand(rng, (21, 30), 1, 255)
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    u, v = _rand(rng, (21, 30), -0.5, 0.5), _rand(rng, (21, 30), -0.5, 0.5)
    got = liu_shen_iter.liu_shen_iteration(u, v, fields, 10.0, ALL)
    saved = hs_iter.pad1_edges
    try:
        hs_iter.pad1_edges = lambda z, e, mode: pad2d(z, 1, mode)
        want = liu_shen_iter.liu_shen_iteration(u, v, fields, 10.0)
    finally:
        hs_iter.pad1_edges = saved
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _window(edges, h, w):
    """The tile (rows, cols) of an (h, w) image whose sides in ``edges`` are
    the image's border, the others T + 2 cells in, and its padded window."""
    top = 0 if edges & hs_iter.TOP else T + 2
    bot = h if edges & hs_iter.BOTTOM else h - T - 3
    left = 0 if edges & hs_iter.LEFT else T + 2
    right = w if edges & hs_iter.RIGHT else w - T - 4
    pad = (slice(top - (0 if edges & hs_iter.TOP else T), bot + (0 if edges & hs_iter.BOTTOM else T)),
           slice(left - (0 if edges & hs_iter.LEFT else T),
                 right + (0 if edges & hs_iter.RIGHT else T)))
    own = (slice(top - pad[0].start, bot - pad[0].start),
           slice(left - pad[1].start, right - pad[1].start))
    return (slice(top, bot), slice(left, right)), pad, own


@pytest.mark.parametrize("edges", MASKS)
@pytest.mark.parametrize("niter", [1, T])
def test_hs_masked_owned_cells_equal_whole_image(edges, niter):
    rng = np.random.default_rng(4)
    h, w = 30, 37
    fx, fy, ft = hs_derivatives(_rand(rng, (h, w), 0, 255), _rand(rng, (h, w), 0, 255))
    u0, v0 = _rand(rng, (h, w), -2, 2), _rand(rng, (h, w), -2, 2)
    whole = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter)
    tile, pad, own = _window(edges, h, w)
    got = hs_iter.hs_iterate_plain(*(z[pad] for z in (fx, fy, ft, u0, v0)), 21.0, niter, edges)
    for g, want in zip(got, whole):
        assert torch.equal(g[own], want[tile])


@pytest.mark.parametrize("edges", MASKS)
def test_ls_masked_owned_cells_equal_whole_image(edges):
    rng = np.random.default_rng(5)
    h, w = 30, 37
    a, b = _rand(rng, (h, w), 1, 255), _rand(rng, (h, w), 1, 255)
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    u0, v0 = _rand(rng, (h, w), -0.5, 0.5), _rand(rng, (h, w), -0.5, 0.5)
    whole = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, T, 0.0)
    tile, pad, own = _window(edges, h, w)
    got = liu_shen_iter.liu_shen_iterate_plain(10.0, [f[pad] for f in fields], u0[pad], v0[pad],
                                               T, 0.0, edges, stop=False)
    assert int(got[3]) == T and bool(torch.isnan(got[2]))
    for g, want in zip(got[:2], whole[:2]):
        assert torch.equal(g[own], want[tile])


def test_ls_no_stop_runs_max_iter_and_equals_stop_at_tol_zero():
    rng = np.random.default_rng(6)
    a, b = _rand(rng, (16, 20), 1, 255), _rand(rng, (16, 20), 1, 255)
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    z = torch.zeros((16, 20))
    with_stop = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, z, z, 9, 0.0)
    no_stop = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, z, z, 9, 1e30, stop=False)
    assert int(with_stop[3]) == int(no_stop[3]) == 9
    for g, w in zip(no_stop[:2], with_stop[:2]):
        assert torch.equal(g, w)
    zero = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, z, z, 0, 0.0, stop=False)
    assert float(zero[2]) == 0.0 and int(zero[3]) == 0


@pytest.mark.parametrize("bad", [-1, 16])
def test_wrappers_reject_bad_masks(bad):
    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="edges"):
        hs_iter.hs_iterate(z, z, z, z, z, 1.0, 1, bad)
    with pytest.raises(ValueError, match="edges"):
        liu_shen_iter.liu_shen_iterate(1.0, [z] * 8, z, z, 1, 0.0, bad)
