"""What the Hopper HS and LK-build kernels take from Python, and the order of
their arithmetic, checked on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).
Here:
  * ``hs_iter.launch_plan``, which splits an HS solve into temporally blocked
    launches and picks each launch's destination buffer, against a direct
    count for every ``niter`` mod T;
  * a NumPy model of one blocked launch of ``csrc/hs_jacobi.cu`` (a tile with
    a T-deep halo, the mirror border as an index rule, a missing neighbour at
    the tile's interior edge read as the cell itself), run tile by tile
    through the plan, against ``hs_iterate_plain`` bit for bit;
  * the ladder table compiled into ``csrc/lk_build.cu`` against
    ``_smooth_factorization``, the run table the wrapper packs, and a NumPy
    model of the kernel's per-thread register ladder (32 outputs a thread in
    the x-pass, 16 in the y-pass, stages in place, remainder taps re-read)
    against the ladder window sum, bit for bit.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, lk_build
from opticalflow_ri_tpu_torch.ops.stencil import TWELFTH
from opticalflow_ri_tpu_torch.ops.window_sums import _smooth_factorization, wsum2d

CSRC = Path(hs_iter.__file__).resolve().parents[2] / "csrc"


# ---------------------------------------------------------------- HS launch plan

@pytest.mark.parametrize("steps", [1, 4, 8, 31])
def test_hs_launch_plan_counts(steps):
    for niter in list(range(0, 3 * steps + 2)) + [45, 100, 600]:
        plan = hs_iter.launch_plan(niter, steps)
        counts = [c for c, _ in plan]
        assert sum(counts) == niter
        assert len(plan) == -(-niter // steps)
        assert all(1 <= c <= steps for c in counts)
        assert counts[:-1] == [steps] * (len(counts) - 1) if counts else True
        dsts = [d for _, d in plan]
        if plan:
            assert dsts[-1] == hs_iter.OUT
            assert all(a != b for a, b in zip(dsts, dsts[1:]))
            # an odd launch count starts on the output, an even one on scratch
            assert dsts[0] == (hs_iter.OUT if len(plan) % 2 else hs_iter.TMP)


def test_hs_launch_plan_edges():
    assert hs_iter.launch_plan(0, 8) == ()
    assert hs_iter.launch_plan(-2, 8) == ()
    assert hs_iter.launch_plan(8, 8) == ((8, hs_iter.OUT),)
    assert hs_iter.launch_plan(9, 8) == ((8, hs_iter.TMP), (1, hs_iter.OUT))
    assert hs_iter.launch_plan(17, 8) == ((8, hs_iter.OUT), (8, hs_iter.TMP), (1, hs_iter.OUT))
    for bad in (0, 32):
        with pytest.raises(ValueError, match="steps per launch"):
            hs_iter.launch_plan(5, bad)
    table = list(hs_iter._plan_table(hs_iter.launch_plan(17, 8)))
    assert table == [8, hs_iter.OUT, 8, hs_iter.TMP, 1, hs_iter.OUT]


def _hs_block_launch(fx, fy, ft, rd, u, v, nit, T, ext):
    """One launch of the blocked HS kernel, modelled tile by tile in float32."""
    h, w = u.shape
    tile = ext - 2 * T
    u_out, v_out = np.full_like(u, np.nan), np.full_like(v, np.nan)
    for oy in range(-T, h - T, tile):
        for ox in range(-T, w - T, tile):
            gy = oy + np.arange(ext)
            gx = ox + np.arange(ext)
            ry = np.flatnonzero((gy >= 0) & (gy < h))  # tile rows inside the image
            rx = np.flatnonzero((gx >= 0) & (gx < w))
            c = np.arange(ext)
            cm = np.where(gx == 0, c + 1, c - 1)
            cp = np.where(gx == w - 1, c - 1, c + 1)
            cm = np.where(cm < 0, c, cm)
            cp = np.where(cp >= ext, c, cp)
            rm = np.where(gy == 0, c + 1, c - 1)
            rp = np.where(gy == h - 1, c - 1, c + 1)
            rm = np.where(rm < 0, c, rm)
            rp = np.where(rp >= ext, c, rp)
            su = np.zeros((ext, ext), np.float32)
            sv = np.zeros((ext, ext), np.float32)
            sl = np.ix_(ry, rx)
            img = np.ix_(gy[ry], gx[rx])
            su[sl], sv[sl] = u[img], v[img]
            cfx, cfy, cft, crd = (a[img] for a in (fx, fy, ft, rd))
            for _ in range(nit):
                du, dv = su.copy(), sv.copy()
                avg = []
                for s in (su, sv):
                    rs = (s[:, cm] + np.float32(2.0) * s[:, c]) + s[:, cp]  # row sums
                    q = (rs[rm] + np.float32(2.0) * rs) + rs[rp]
                    avg.append(((q - np.float32(4.0) * s) * np.float32(TWELFTH))[sl])
                ua, va = avg
                der = ((cfx * ua + cfy * va) + cft) * crd
                du[sl], dv[sl] = ua - cfx * der, va - cfy * der
                su, sv = du, dv
            keep = (ry >= T) & (ry < T + tile)
            keepx = (rx >= T) & (rx < T + tile)
            out = np.ix_(gy[ry][keep], gx[rx][keepx])
            u_out[out] = su[np.ix_(ry[keep], rx[keepx])]
            v_out[out] = sv[np.ix_(ry[keep], rx[keepx])]
    return u_out, v_out


@pytest.mark.parametrize("shape", [(2, 2), (3, 17), (13, 21)])
@pytest.mark.parametrize("ext,T", [(8, 2), (9, 3), (64, 8)])
def test_hs_blocked_model_equals_plain(shape, ext, T):
    """Every niter mod T, through the plan's launches and buffers."""
    rng = np.random.default_rng(7)
    fx, fy, ft, u0, v0 = (rng.uniform(-3, 3, shape).astype(np.float32) for _ in range(5))
    alpha = np.float32(21.0)
    rd = np.float32(1.0) / ((alpha * alpha + fx * fx) + fy * fy)
    for niter in sorted({0, 1, T - 1, T, T + 1, 2 * T + 1, 7}):
        bufs = {"in": (u0, v0)}
        src = "in"
        for nit, dst in hs_iter.launch_plan(niter, T):
            bufs[dst] = _hs_block_launch(fx, fy, ft, rd, *bufs[src], nit, T, ext)
            src = dst
        got = bufs[hs_iter.OUT] if niter > 0 else (u0, v0)
        want = hs_iter.hs_iterate_plain(*(torch.from_numpy(a) for a in (fx, fy, ft, u0, v0)),
                                        21.0, niter)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_.numpy())


# ---------------------------------------------------------------- LK build

def _compiled_ladders():
    text = (CSRC / "lk_build.cu").read_text()
    rows = re.findall(r"\{([0-9, ]+)\},\s*// L = (\d+)", text)
    return {int(L): [int(f) for f in facs.split(",") if int(f)] for facs, L in rows}


def test_lk_ladder_table_matches_factorization():
    table = _compiled_ladders()
    assert sorted(table) == list(range(0, lk_build.GRID + 1))
    for L in range(1, lk_build.GRID + 1):
        assert table[L] == _smooth_factorization(L)[0], L
        assert len(table[L]) <= lk_build.MAX_FACTORS


def test_lk_run_table_packs_four_runs():
    runs = ((0, 3), (5, 10), (12, 26), (28, 31))
    table = list(lk_build.run_table(runs))
    assert len(table) == lk_build.TABLE_INTS == 1 + 4 * (4 + 5)
    assert table[0] == 4
    for q, (lo, hi) in enumerate(runs):
        rec = table[1 + q * lk_build.RUN_INTS: 1 + (q + 1) * lk_build.RUN_INTS]
        L = hi - lo + 1
        facs = _compiled_ladders()[L]
        assert rec[:4] == [lo, L, max(1, round(L ** 0.5)), len(facs)]
        assert rec[4:] == facs + [0] * (lk_build.MAX_FACTORS - len(facs))
    with pytest.raises(ValueError, match="1 to 4"):
        lk_build.run_table(runs + ((2, 2),))


SEG_X, SEG_Y = 32, 16  # outputs a thread sums in each pass of csrc/lk_build.cu


def _segment_ladder(x, runs, out_len, seg):
    """The kernel's per-thread ladder along the last axis of ``x``: each
    thread takes ``seg`` outputs, copies the inputs it needs, runs the stages
    in place (stage s forms seg + M - m_{s+1} entries), then adds the
    remainder taps re-read from ``x``; run terms added in run order."""
    table = _compiled_ladders()
    n_seg = -(-out_len // seg)
    pad = n_seg * seg + lk_build.EXT - x.shape[-1]
    xp = np.concatenate([x, np.zeros(x.shape[:-1] + (max(pad, 0),), np.float32)], axis=-1)
    out = np.zeros(x.shape[:-1] + (n_seg * seg,), np.float32)
    for s0 in range(0, n_seg * seg, seg):
        acc = None
        for lo, hi in runs:
            L = hi - lo + 1
            facs = table[L]
            M = math.prod(facs)
            v = [xp[..., s0 + lo + i].copy() for i in range(seg + M - 1)]
            m = 1
            for f in facs:
                for i in range(seg + M - m * f):
                    a = v[i]
                    for j in range(1, f):
                        a = a + v[i + j * m]
                    v[i] = a
                m *= f
            term = []
            for k in range(seg):
                t = v[k]
                for j in range(M, L):
                    t = t + xp[..., s0 + lo + k + j]
                term.append(t)
            term = np.stack(term, axis=-1)
            acc = term if acc is None else acc + term
        out[..., s0:s0 + seg] = acc
    return out[..., :out_len]


@pytest.mark.parametrize("runs", [((0, 26),), ((0, 7), (9, 26)), ((0, 25),),
                                  ((0, 3), (5, 10), (12, 26), (28, 31)), ((0, 31),), ((4, 4),)],
                         ids=["sym27", "near", "far", "four_runs", "full32", "single"])
@pytest.mark.parametrize("shape", [(5, 7), (33, 70)])
def test_lk_segment_ladder_equals_wsum(runs, shape):
    rng = np.random.default_rng(11)
    h, w = shape
    x = rng.normal(0, 100, (h + lk_build.EXT, w + lk_build.EXT)).astype(np.float32)
    # x-pass over every product row, then the y-pass down each column
    t = _segment_ladder(x, runs, w, SEG_X)
    got = _segment_ladder(t.T.copy(), runs, h, SEG_Y).T
    want = wsum2d(torch.from_numpy(x), runs, runs, 13, h, w, "ladder").numpy()
    np.testing.assert_array_equal(got, want)
