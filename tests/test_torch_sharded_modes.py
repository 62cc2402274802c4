"""The sharded modes of K7, K9-K11 and K12/K13 in the port's plain versions,
against the JAX package's kernels in Pallas interpret mode on the CPU.

A rows-sharded solve (``parallel/sharded_kernel.py``) hands each kernel a
stripe of the image and its place in it:
  * K7 (``lk_gn_iterate_plain``): ``row0``, ``img_h``, ``img_w``, against
    ``lk_gn_iterate_pallas(..., row0=, img_h=, img_w=)``;
  * K9-K11 (``update_matrices_plain``): ``row0``, ``img_rows`` and an R1
    with its neighbours' rows (``apron``), against
    ``tent_sample_channel_call`` on a caller-padded R1, then JAX's
    ``assemble_m(row0=, img_rows=)`` (``sharded_pallas.py:387-408``);
  * K12/K13 (``blur5_flow_plain``): the per-side y mask ``edges`` with
    half a window of neighbour M on each interior side, against
    ``blur5_flow_call`` on the same rows padded as the JAX sharded body
    pads them (``sharded_pallas.py:410-416``).
Bars: the JAX package's own for these kernels (LK 1.2e-4 on the window
origins with status equal; the channel sampler 2e-6 x max|M|, rtol 1e-4;
blur5 1e-4 on the flow).  Each stripe also equals the whole-image plain
call on its rows bit for bit, and with every side on the border each plain
version, given its whole-image arguments explicitly, is the default call
bit for bit.  Stripes are 16 or 32 rows of 64 x 128 images: interpret mode
is slow.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu.models import farneback as jfb
from opticalflow_ri_tpu.models import lucas_kanade as jlk
from opticalflow_ri_tpu.ops.pallas.blur5_flow import blur5_flow_call
from opticalflow_ri_tpu.ops.pallas.lk_iter import lk_gn_iterate_pallas
from opticalflow_ri_tpu.ops.pallas.tent_sample import tent_sample_channel_call
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch.models import farneback as tfb
from opticalflow_ri_tpu_torch.models import lucas_kanade as tlk
from opticalflow_ri_tpu_torch.ops import window_sums as tws
from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow, lk_iter, tent_sample
from opticalflow_ri_tpu_torch.ops.cuda.hs_iter import BOTTOM, TOP

LK_BAR = 1.2e-4
H, W = 64, 128
HW, R = 13, 5
# (row0, rows) of a stripe of the H-row image: top border, interior, bottom border
STRIPES = [(0, 16), (24, 16), (48, 16)]
STRIPE_IDS = ["top", "interior", "bottom"]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rows(a, lo, hi):
    """Rows lo..hi-1 of the last-but-one axis, clamped into the array (the
    replicate rule beyond its edges)."""
    idx = np.clip(np.arange(lo, hi), 0, a.shape[-2] - 1)
    return np.ascontiguousarray(np.take(a, idx, axis=-2))


# ------------------------------------------------------------------ K7

def _gn_problem():
    """Planes and fields of a whole 64 x 128 pair (the JAX XLA build), and
    initial flows that push some pixels past the image's bottom edge."""
    rng = np.random.default_rng(11)
    im1 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    im2 = (np.roll(im1, (1, 2), axis=(0, 1))
           + rng.normal(0, 2, (H, W)).astype(np.float32)).astype(np.float32)
    runs = tws.runs_from_mask(tlk.window_mask(2 * HW + 1, 0, 0))
    pad = tlk.lk_pad(R)
    jf = jlk.lk_solve_fields(jnp.pad(jnp.asarray(im1), pad, mode="edge"),
                             jnp.pad(jnp.asarray(im2), pad, mode="edge"), HW, R, runs, runs, H, W)
    t1, t2 = jlk.lk_build_planes(jf[1], jf[0], runs, runs, HW, H, W, R, hierarchical="ladder")
    u0 = rng.uniform(-3, 3, (H, W)).astype(np.float32)
    v0 = rng.uniform(-3, 3, (H, W)).astype(np.float32)
    v0[H - 8 :, ::3] = 14.5   # these window origins start at or past img_h: they bail
    ii = np.arange(H, dtype=np.float32)[:, None] + np.zeros((1, W), np.float32)
    jj = np.arange(W, dtype=np.float32)[None, :] + np.zeros((H, 1), np.float32)
    _, _, ia11, ia12, ia22, c1, c2, ok = (np.asarray(f) for f in jf)
    fields = [ia11, ia12, ia22, c1, c2, ok.astype(np.float32),
              (jj + u0 - HW).astype(np.float32), (ii + v0 - HW).astype(np.float32)]
    return np.asarray(t1), np.asarray(t2), fields


@pytest.fixture(scope="module")
def gn_problem():
    return _gn_problem()


@pytest.mark.parametrize("row0,rows", STRIPES, ids=STRIPE_IDS)
def test_gn_stripe_matches_tpu_kernel_interpret(gn_problem, row0, rows):
    """K7's plain version on a stripe in global rows against the TPU kernel
    with the same row0/img_h/img_w (bar 1.2e-4, status equal), and the
    stripe equal to the whole-image call's rows bit for bit."""
    t1, t2, fields = gn_problem
    sl = slice(row0, row0 + rows)
    args = [_t(t1[:, sl]), _t(t2[:, sl])] + [_t(f[sl]) for f in fields]
    got = lk_iter.lk_gn_iterate_plain(*args, 5, R, HW, row0=row0, img_h=H, img_w=W)
    want = lk_gn_iterate_pallas(*(jnp.asarray(a.numpy()) for a in args), 5, R, HW,
                                interpret=True, row0=row0, img_h=H, img_w=W)
    for g, w_, name in zip(got, want, ("px", "py")):
        assert float(np.abs(g.numpy() - np.asarray(w_)).max()) <= LK_BAR, name
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    whole = lk_iter.lk_gn_iterate_plain(*(_t(a) for a in (t1, t2, *fields)), 5, R, HW)
    for g, w_ in zip(got, whole):
        assert torch.equal(g, w_[sl])
    if row0 + rows == H:  # pixels bail at the global bottom, not at the stripe's
        bailed = (got[2] == 0) & (args[7] > 0)
        assert int(bailed.sum()) > 0
        assert bool((got[1][bailed] >= H).any())


def test_gn_whole_image_arguments_are_the_default(gn_problem):
    t1, t2, fields = gn_problem
    args = [_t(a) for a in (t1, t2, *fields)]
    got = lk_iter.lk_gn_iterate_plain(*args, 5, R, HW, row0=0, img_h=H, img_w=W)
    for g, w_ in zip(got, lk_iter.lk_gn_iterate_plain(*args, 5, R, HW)):
        assert torch.equal(g, w_)
    wrapped = lk_iter.lk_gn_iterate(*args, 5, R, HW, row0=0, img_h=H, img_w=W)
    assert all(torch.equal(g, w_) for g, w_ in zip(wrapped, got))


@pytest.mark.parametrize("row0,img_h", [(-1, H), (1, H)])
def test_gn_rejects_a_stripe_outside_the_image(gn_problem, row0, img_h):
    t1, t2, fields = gn_problem
    args = [_t(a) for a in (t1, t2, *fields)]
    with pytest.raises(ValueError, match="do not lie"):
        lk_iter.lk_gn_iterate_plain(*args, 1, R, HW, row0=row0, img_h=img_h)


# ---------------------------------------------------------------- K9-K11

@pytest.fixture(scope="module")
def um_problem():
    rng = np.random.default_rng(13)
    ims = [rng.uniform(0, 255, (H, W)).astype(np.float32) for _ in range(2)]
    r0, r1 = (np.asarray(jfb.poly_expansion(jnp.asarray(im), 7, 1.5, impl="vpu"))
              for im in ims)
    fx, fy = (rng.uniform(-5, 5, (H, W)).astype(np.float32) for _ in range(2))
    fy[-4:, :8] = 6.0  # samples past the bottom edge
    return r0, r1, fx, fy


@pytest.mark.parametrize("row0,rows", STRIPES, ids=STRIPE_IDS)
def test_update_matrices_stripe_matches_channel_pallas_interpret(um_problem, row0, rows):
    """The stripe mode against the channel sampler on R1 padded as the JAX
    sharded body pads it ((R, R + 1) rows, the neighbours' inside the
    image, edge rows beyond it; then R, R + 1 edge columns) and JAX's
    assemble_m in global rows; the port's R1 holds R neighbour rows on its
    interior sides only.  Bar: the dense sampler's, 2e-6 x max|M|, rtol
    1e-4."""
    r0, r1, fx, fy = um_problem
    sl = slice(row0, row0 + rows)
    a_top = R if row0 > 0 else 0
    a_bot = R if row0 + rows < H else 0
    got = tent_sample.update_matrices_plain(
        _t(fx[sl]), _t(fy[sl]), _t(r0[:, sl]), _t(r1[:, row0 - a_top : row0 + rows + a_bot]), R,
        row0=row0, img_rows=H, apron=(a_top, a_bot))

    r1p = np.pad(_rows(r1, row0 - R, row0 + rows + R + 1), ((0, 0), (0, 0), (R, R + 1)),
                 mode="edge")
    s = tent_sample_channel_call(jnp.asarray(r1p), jnp.asarray(fx[sl]), jnp.asarray(fy[sl]), R,
                                 interpret=True)[:, :rows, :W]
    ys = np.arange(row0, row0 + rows, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    x1, y1 = np.floor(xs + fx[sl]), np.floor(ys + fy[sl])
    inside = (x1 >= 0) & (y1 >= 0) & (x1 < W - 1) & (y1 < H - 1)
    want = np.asarray(jfb.assemble_m(s, jnp.asarray(r0[:, sl]), jnp.asarray(fx[sl]),
                                     jnp.asarray(fy[sl]), jnp.asarray(inside), row0=row0,
                                     img_rows=H))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6 * scale, rtol=1e-4)
    whole = tent_sample.update_matrices_plain(*(_t(a) for a in (fx, fy, r0, r1)))
    assert torch.equal(got, whole[:, sl])


@pytest.mark.parametrize("apron", [(5, 5), (7, 6), (0, 5)], ids=["R", "wider", "top-border"])
def test_update_matrices_stripe_reads_only_rows_present(um_problem, apron):
    """A wider apron than R changes nothing (the clipped displacement reads
    at most R rows away); a side without one clamps into the stripe."""
    r0, r1, fx, fy = um_problem
    row0, rows = (24, 16) if apron[0] else (0, 16)
    a_top, a_bot = apron
    sl = slice(row0, row0 + rows)
    got = tent_sample.update_matrices_plain(
        _t(fx[sl]), _t(fy[sl]), _t(r0[:, sl]), _t(r1[:, row0 - a_top : row0 + rows + a_bot]), R,
        row0=row0, img_rows=H, apron=apron)
    whole = tent_sample.update_matrices_plain(*(_t(a) for a in (fx, fy, r0, r1)))
    assert torch.equal(got, whole[:, sl])


def test_update_matrices_whole_image_arguments_are_the_default(um_problem):
    args = [_t(a) for a in (um_problem[2], um_problem[3], um_problem[0], um_problem[1])]
    want = tent_sample.update_matrices_plain(*args)
    got = tent_sample.update_matrices_plain(*args, R, row0=0, img_rows=H, apron=(0, 0))
    assert torch.equal(got, want)
    assert torch.equal(tent_sample.update_matrices(*args, R, row0=0, img_rows=H), want)


@pytest.mark.parametrize("kw,match", [
    ({"apron": (2, 0)}, "r1 must be"),
    ({"row0": 60, "img_rows": H}, "do not lie"),
    ({"sample_max_shift": None, "row0": 1, "img_rows": H + 1}, "no stripe mode"),
], ids=["r1-shape", "extent", "exact-gather"])
def test_update_matrices_rejects_bad_stripes(um_problem, kw, match):
    r0, r1, fx, fy = um_problem
    with pytest.raises(ValueError, match=match):
        tent_sample.update_matrices_plain(*(_t(a) for a in (fx, fy, r0, r1)), **kw)


# --------------------------------------------------------------- K12/K13

@pytest.fixture(scope="module")
def blur_m():
    """M of a particle pair at a smooth flow (a well-conditioned solve)."""
    im1, im2, _, _ = particle_image_pair(shape=(H, W), seed=7)
    r0, r1 = (tfb.poly_expansion(_t(im), 7, 1.5) for im in (im1, im2))
    yy = torch.arange(H, dtype=torch.float32)[:, None] * torch.ones((1, W))
    fx, fy = 2.0 * torch.sin(yy / 20.0), 1.5 * torch.cos(yy / 30.0)
    return tent_sample.update_matrices_plain(fx, fy, r0, r1).numpy()


# (edges, row0, rows): the four masks on stripes of the 64-row M
MASKS = [(TOP | BOTTOM, 0, H), (TOP, 0, 32), (BOTTOM, 32, 32), (0, 16, 32)]
MASK_IDS = ["both-border", "top-border", "bottom-border", "interior"]


@pytest.mark.parametrize("use_gaussian", [True, False], ids=["gaussian", "box"])
@pytest.mark.parametrize("edges,row0,rows", MASKS, ids=MASK_IDS)
def test_blur5_flow_mask_matches_pallas_interpret(blur_m, use_gaussian, edges, row0, rows):
    """K12's plain version under each y mask, half a window of neighbour M on
    each interior side, against blur5_flow_call on M padded as the JAX
    sharded body pads it (neighbour rows inside the image, the window's
    border rule beyond it, in y and in x): flow within 1e-4; and the
    stripe equal to the whole-image call's rows bit for bit."""
    taps, mode, scale = tfb._window_blur_spec(33, use_gaussian)
    half = len(taps) // 2
    a_top = 0 if edges & TOP else half
    a_bot = 0 if edges & BOTTOM else half
    mine = _t(blur_m[:, row0 - a_top : row0 + rows + a_bot])
    got = blur5_flow.blur5_flow_plain(mine, taps, mode, scale, edges)

    jmode = {"mirror": "reflect", "nearest": "edge"}[mode]
    mp = np.pad(blur_m, ((0, 0), (half, half), (half, half)), mode=jmode)
    mp = mp[:, row0 : row0 + rows + 2 * half]
    want = blur5_flow_call(jnp.asarray(mp), tuple(float(x) for x in taps), rows, W, scale,
                           interpret=True)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_)[:rows, :W], atol=1e-4, rtol=0)
    whole = blur5_flow.blur5_flow_plain(_t(blur_m), taps, mode, scale)
    for g, w_ in zip(got, whole):
        assert torch.equal(g, w_[row0 : row0 + rows])


@pytest.mark.parametrize("use_gaussian", [True, False], ids=["gaussian", "box"])
def test_blur5_flow_both_borders_is_the_default(blur_m, use_gaussian):
    taps, mode, scale = tfb._window_blur_spec(33, use_gaussian)
    m = _t(blur_m)
    want = blur5_flow.blur5_flow_plain(m, taps, mode, scale)
    got = blur5_flow.blur5_flow_plain(m, taps, mode, scale, TOP | BOTTOM)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    wrapped = blur5_flow.blur5_flow(m, taps, mode, scale, TOP | BOTTOM)
    assert all(torch.equal(g, w_) for g, w_ in zip(wrapped, want))


@pytest.mark.parametrize("edges,rows", [(4, H), (0, 33)], ids=["x-bit", "no-field"])
def test_blur5_flow_rejects_bad_masks(blur_m, edges, rows):
    taps, mode, scale = tfb._window_blur_spec(33, True)
    with pytest.raises(ValueError):
        blur5_flow.blur5_flow_plain(_t(blur_m[:, :rows]), taps, mode, scale, edges)
