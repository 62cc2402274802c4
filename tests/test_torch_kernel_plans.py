"""What the Hopper HS, Liu-Shen, LK-build and Farneback blur kernels take
from Python, and the order of their arithmetic, checked on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).
Here:
  * ``hs_iter.launch_plan``, which splits an HS solve into temporally blocked
    launches and picks each launch's destination buffer, against a direct
    count for every ``niter`` mod T;
  * a NumPy model of one blocked launch of ``csrc/hs_jacobi.cu`` (a tile with
    a T-deep halo, the mirror border as an index rule, a missing neighbour at
    the tile's interior edge read as the cell itself), run tile by tile
    through the plan, against ``hs_iterate_plain`` bit for bit;
  * K1's path rule and tile sizing, ``hs_iter.resident_tiles`` (a pure
    function of (h, w, niter, SM count): the 512^2 configurations' levels
    resident on at least 120 of the H100's 132 SMs, 2048^2 and the sharded
    tiles blocked, every tiling within the kernel entry's rules), a NumPy
    model of the resident schedule (rounds, the cores' bands published, the
    rings read back) against ``hs_iterate_plain`` bit for bit under four
    ``edges`` masks, and the ``hs_iterate.resident`` counter;
  * the ladder table compiled into ``csrc/lk_build.cu`` against
    ``_smooth_factorization``, the run table the wrapper packs, and a NumPy
    model of the kernel's per-thread register ladder (32 outputs a thread in
    the x-pass, 16 in the y-pass, stages in place, remainder taps re-read)
    against the ladder window sum, bit for bit;
  * ``liu_shen_iter.launch_plan`` and ``stop_buffers`` (where the replay of a
    stop inside a launch reads and writes), and a NumPy model of the blocked
    Liu-Shen launches of ``csrc/liu_shen.cu`` (the "nearest" border and the
    ring's zero border as index rules, err from the owned cells, the first
    step at or under tol, the replay) against ``liu_shen_iterate_plain``: u,
    v bit for bit and k equal, for stops at the first, an interior and the
    last step of a launch;
  * a NumPy model of the register-blocked sliding-window pass of
    ``csrc/fb_blur5_flow.cu`` (R outputs a thread, a ring of R inputs, taps in
    ascending order from -0) against ``ops/stencil.correlate1d`` bit for bit;
  * a NumPy model of the persistent schedule of ``csrc/fb_fused.cu`` (G
    blocks walking T tiles, each tile blurred from its halo by the tile
    routine's passes, M in two ping-pong buffers, the flow written in the last
    round only) against ``fb_fused_plain`` bit for bit;
  * a PyTorch model of the tiles of ``csrc/fb_poly_expand.cu`` (each tile
    staged with its n-row and n-column aprons, the vertical then the
    horizontal sums from -0 with zero taps skipped, the combinations)
    against ``poly_expansion`` bit for bit, on whole images and on stripes
    whose aprons are a neighbour's rows; and what ``poly_expand`` takes.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
from opticalflow_ri_tpu_torch.ops.cuda import (
    blur5_flow, fb_fused, hs_iter, liu_shen_iter, lk_build, lk_iter, poly_expand, tent_sample,
)
from opticalflow_ri_tpu_torch.ops.padding import _pad_index
from opticalflow_ri_tpu_torch.ops.stencil import TWELFTH, correlate1d
from opticalflow_ri_tpu_torch.ops.window_sums import _smooth_factorization, base_width, wsum2d

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
    table = list(hs_iter.plan_table(hs_iter.launch_plan(17, 8)))
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


# ---------------------------------------------------------------- HS resident path

H100_SMS = 132


def _tiling_ok(tiles, h, w, sms):
    """The kernel entry's rules for a resident tiling (csrc/hs_jacobi.cu)."""
    t = tiles
    assert t.strips in hs_iter.RESIDENT_STRIPS and t.ring >= 1 and t.core_w >= 1
    assert t.rows * t.strips <= hs_iter.MAX_THREADS and t.rows * t.strips % 32 == 0
    assert 1 <= t.tiles <= sms
    assert (t.grid_y - 1) * t.core_h < h <= t.grid_y * t.core_h
    assert (t.grid_x - 1) * t.core_w < w <= t.grid_x * t.core_w
    if t.tiles > 1:
        assert 1 <= t.round <= t.ring
        assert t.grid_y == 1 or t.ring <= t.core_h
        assert t.grid_x == 1 or t.ring <= t.core_w
    else:
        assert t.ring == 1 and t.round >= 1


@pytest.mark.parametrize("n", [256, 512])
def test_hs_resident_tiles_cover_the_card(n):
    """The two levels of the ls_hs_512 configuration, 600 iterations each:
    one resident launch whose tiles cover at least 120 of the H100's 132
    SMs, each a valid tiling."""
    tiles = hs_iter.resident_tiles(n, n, 600, H100_SMS)
    assert tiles is not None
    _tiling_ok(tiles, n, n, H100_SMS)
    assert 120 <= tiles.tiles <= H100_SMS
    assert tiles.exchanges(600) == -(-600 // tiles.round) - 1


@pytest.mark.parametrize("shape", [(2048, 2048), (1024, 1024), (1032, 1032), (2048, 1032),
                                   (520, 2056)])
@pytest.mark.parametrize("niter", [0, 1, 8, 100, 600])
def test_hs_resident_tiles_leave_large_shapes_blocked(shape, niter):
    """Shapes whose tiles do not fit one wave (2048^2, the sharded solves'
    1024^2 and 2048 x 1024 tiles with their aprons, a rows-sharded stripe)
    take the blocked path; its launch plan is the one it was."""
    assert hs_iter.resident_tiles(*shape, niter, H100_SMS) is None
    assert hs_iter.launch_plan(600, hs_iter.STEPS_PER_LAUNCH) == tuple(
        (8, hs_iter.OUT if k % 2 == 0 else hs_iter.TMP) for k in range(75))


@pytest.mark.parametrize("shape", [(2, 2), (3, 517), (47, 61), (333, 517), (256, 256),
                                   (512, 512), (264, 264), (600, 300), (517, 3), (64, 64)])
@pytest.mark.parametrize("niter", [0, 1, 7, 8, 9, 45, 600])
@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_hs_resident_tiles_are_valid(shape, niter, sms):
    """Every tiling the rule picks keeps the kernel's rules, on the H100's
    SM count and on smaller cards; 600 iterations at 512^2 take the tiling
    the rule gives for the SM count alone (the path reads nothing else)."""
    tiles = hs_iter.resident_tiles(*shape, niter, sms)
    if tiles is None:
        assert sms < H100_SMS
        return
    _tiling_ok(tiles, *shape, sms)
    assert hs_iter.resident_tiles(*shape, niter, sms) is tiles  # a pure function, cached


def _hs_resident_model(fx, fy, ft, u0, v0, alpha, niter, edges, tiles):
    """The resident launch modelled tile by tile in float32: each tile's
    extended state kept across rounds, every ``round`` iterations the cores'
    bands published into NaN-filled planes and each ring read back from
    them (a NaN read would be a ring cell no neighbour published)."""
    h, w = u0.shape
    t = tiles
    W = 4 * t.strips
    rd = np.float32(1.0) / ((np.float32(alpha) * np.float32(alpha) + fx * fx) + fy * fy)
    state = []
    for by in range(t.grid_y):
        for bx in range(t.grid_x):
            gy = by * t.core_h - t.ring + np.arange(t.rows)
            gx = bx * t.core_w - t.ring + np.arange(W)
            ry = np.flatnonzero((gy >= 0) & (gy < h))
            rx = np.flatnonzero((gx >= 0) & (gx < w))
            r, c = np.arange(t.rows), np.arange(W)
            rm = np.where((gy == 0) & bool(edges & hs_iter.TOP), r + 1, r - 1)
            rp = np.where((gy == h - 1) & bool(edges & hs_iter.BOTTOM), r - 1, r + 1)
            cm = np.where((gx == 0) & bool(edges & hs_iter.LEFT), c + 1, c - 1)
            cp = np.where((gx == w - 1) & bool(edges & hs_iter.RIGHT), c - 1, c + 1)
            rm, cm = np.where(rm < 0, r, rm), np.where(cm < 0, c, cm)
            rp, cp = np.where(rp >= t.rows, r, rp), np.where(cp >= W, c, cp)
            sl, img = np.ix_(ry, rx), np.ix_(gy[ry], gx[rx])
            su, sv = np.zeros((t.rows, W), np.float32), np.zeros((t.rows, W), np.float32)
            su[sl], sv[sl] = u0[img], v0[img]
            core = np.zeros((t.rows, W), bool)
            core[t.ring:t.ring + t.core_h, t.ring:t.ring + t.core_w] = True
            inside = np.zeros((t.rows, W), bool)
            inside[sl] = True
            state.append(dict(gy=gy, gx=gx, rm=rm, rp=rp, cm=cm, cp=cp, sl=sl, img=img, su=su,
                              sv=sv, core=core, inside=inside,
                              coef=tuple(a[img] for a in (fx, fy, ft, rd))))
    done = 0
    while True:
        n = min(t.round, niter - done)
        for s in state:
            cfx, cfy, cft, crd = s["coef"]
            for _ in range(n):
                avg = []
                for f in (s["su"], s["sv"]):
                    rs = (f[:, s["cm"]] + np.float32(2.0) * f) + f[:, s["cp"]]
                    q = (rs[s["rm"]] + np.float32(2.0) * rs) + rs[s["rp"]]
                    avg.append(((q - np.float32(4.0) * f) * np.float32(TWELFTH))[s["sl"]])
                ua, va = avg
                der = ((cfx * ua + cfy * va) + cft) * crd
                s["su"], s["sv"] = s["su"].copy(), s["sv"].copy()
                s["su"][s["sl"]], s["sv"][s["sl"]] = ua - cfx * der, va - cfy * der
        done += n
        if done >= niter:
            break
        xu, xv = np.full((h, w), np.nan, np.float32), np.full((h, w), np.nan, np.float32)
        for s in state:
            r, c = np.nonzero(s["core"] & s["inside"])
            band = ((r < 2 * t.ring) | (r >= t.core_h) | (c < 2 * t.ring) | (c >= t.core_w))
            r, c = r[band], c[band]
            xu[s["gy"][r], s["gx"][c]] = s["su"][r, c]
            xv[s["gy"][r], s["gx"][c]] = s["sv"][r, c]
        for s in state:
            r, c = np.nonzero(~s["core"] & s["inside"])
            s["su"][r, c] = xu[s["gy"][r], s["gx"][c]]
            s["sv"][r, c] = xv[s["gy"][r], s["gx"][c]]
            assert not np.isnan(s["su"][r, c]).any(), "a ring cell no neighbour published"
    u_out, v_out = np.full((h, w), np.nan, np.float32), np.full((h, w), np.nan, np.float32)
    for s in state:
        r, c = np.nonzero(s["core"] & s["inside"])
        u_out[s["gy"][r], s["gx"][c]] = s["su"][r, c]
        v_out[s["gy"][r], s["gx"][c]] = s["sv"][r, c]
    return u_out, v_out


def _tiling(h, w, strips, ring, core_h):
    core_w = 4 * strips - 2 * ring
    return hs_iter.ResidentTiles(strips, ring, core_h, -(-h // core_h), -(-w // core_w), ring)


RESIDENT_MODEL_CASES = [
    ((13, 21), _tiling(13, 21, 8, 1, 14)),      # one tile: ring 1, no round
    ((40, 70), _tiling(40, 70, 8, 3, 6)),       # 7 x 3 tiles, rings of 3
    ((40, 70), _tiling(40, 70, 8, 7, 10)),      # rings 7 deep, 10-row cores
    ((37, 61), _tiling(37, 61, 16, 2, 8)),      # 64-wide tiles, a ragged last row and column
    ((9, 50), _tiling(9, 50, 8, 5, 10)),        # one row of tiles: a ring deeper than the image
]


@pytest.mark.parametrize("shape,tiles", RESIDENT_MODEL_CASES,
                         ids=[f"{s[0]}x{s[1]}-{t.strips}-{t.ring}-{t.core_h}"
                              for s, t in RESIDENT_MODEL_CASES])
@pytest.mark.parametrize("edges", [hs_iter.ALL, 0, hs_iter.TOP | hs_iter.LEFT,
                                   hs_iter.BOTTOM | hs_iter.RIGHT])
def test_hs_resident_model_equals_plain(shape, tiles, edges):
    """The resident schedule (rounds of ``round`` iterations, the cores'
    bands traded into the rings) equals ``hs_iterate_plain`` bit for bit at
    every niter mod the ring's depth, under four ``edges`` masks."""
    h, w = shape
    _tiling_ok(tiles, h, w, H100_SMS)
    rng = np.random.default_rng(11)
    fx, fy, ft, u0, v0 = (rng.uniform(-3, 3, shape).astype(np.float32) for _ in range(5))
    T = tiles.ring
    for niter in sorted({0, 1, T - 1, T, T + 1, 2 * T + 1, 3 * T}):
        got = _hs_resident_model(fx, fy, ft, u0, v0, 21.0, niter, edges, tiles)
        want = hs_iter.hs_iterate_plain(*(torch.from_numpy(a) for a in (fx, fy, ft, u0, v0)),
                                        21.0, niter, edges)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_.numpy())


def test_hs_iterate_counts_the_resident_solves(monkeypatch):
    """``hs_iterate.launches`` counts every call that launches the kernel,
    ``hs_iterate.resident`` those on the resident path: a 256^2 and a 512^2
    solve of 600 iterations (the ls_hs_512 configuration's two levels) one
    each, a 2048^2 solve none; CPU tensors, which take the plain version,
    neither.  The launches are stubbed: meta tensors stand for the card's."""
    calls = []
    monkeypatch.setattr(hs_iter.build, "check_fields", lambda *a: None)
    monkeypatch.setattr(hs_iter, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(hs_iter, "_blocked", lambda *a: calls.append("blocked"))
    monkeypatch.setattr(hs_iter, "_resident",
                        lambda *a: calls.append(("resident", a[-1].tiles)))
    monkeypatch.setattr(hs_iter.hs_iterate, "launches", 0)
    monkeypatch.setattr(hs_iter.hs_iterate, "resident", 0)
    for n in (256, 512, 2048):
        z = torch.empty((n, n), device="meta")
        hs_iter.hs_iterate(z, z, z, z, z, 21.0, 600)
    assert (hs_iter.hs_iterate.launches, hs_iter.hs_iterate.resident) == (3, 2)
    assert [c if c == "blocked" else c[0] for c in calls] == ["resident", "resident", "blocked"]
    assert all(c[1] >= 120 for c in calls if c != "blocked")
    z = torch.zeros((8, 8))
    hs_iter.hs_iterate(z, z, z, z, z, 21.0, 600)
    assert (hs_iter.hs_iterate.launches, hs_iter.hs_iterate.resident) == (3, 2)


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


# ---------------------------------------------------------------- Liu-Shen

LS = liu_shen_iter


def _alternating(counts):
    return tuple((c, LS.OUT if (len(counts) - 1 - j) % 2 == 0 else LS.TMP)
                 for j, c in enumerate(counts))


LS_PLANS = {
    6: {0: (), 1: ((1, LS.OUT),), 5: ((5, LS.OUT),), 6: ((6, LS.OUT),),
        7: ((6, LS.TMP), (1, LS.OUT)),
        60: tuple((6, LS.TMP if j % 2 == 0 else LS.OUT) for j in range(10))},
    8: {0: (), 1: ((1, LS.OUT),), 7: ((7, LS.OUT),), 8: ((8, LS.OUT),),
        9: ((8, LS.TMP), (1, LS.OUT)),
        60: tuple((8 if j < 7 else 4, LS.TMP if j % 2 == 0 else LS.OUT) for j in range(8))},
}


@pytest.mark.parametrize("T,max_iter", [(T, m) for T, plans in LS_PLANS.items() for m in plans])
def test_ls_launch_plan(T, max_iter):
    """Counts and destinations at 0, 1, T-1, T, T+1 and 60 steps, and where
    the replay of a stop in each launch reads and writes."""
    plan = LS.launch_plan(max_iter, T)
    assert plan == LS_PLANS[T][max_iter]
    assert plan == _alternating([c for c, _ in plan])
    srcs = [LS.IN] + [d for _, d in plan[:-1]]
    for j, (_, dst) in enumerate(plan):
        # the replay reads the launch's source, which that launch leaves
        # untouched, and writes its destination
        assert LS.stop_buffers(plan, j) == (srcs[j], dst)
        assert srcs[j] != dst


def test_ls_launch_plan_rejects_depths():
    for bad in (0, LS.MAX_STEPS_PER_LAUNCH + 1):
        with pytest.raises(ValueError, match="steps per launch"):
            LS.launch_plan(60, bad)
    assert LS.STEPS_PER_LAUNCH in LS_PLANS
    assert LS.launch_plan(60, LS.STEPS_PER_LAUNCH) == LS_PLANS[LS.STEPS_PER_LAUNCH][60]


def _ls_block_launch(fields, hreg, u, v, nit, T, ext):
    """One launch of the blocked Liu-Shen kernel on an ext = (rows, cols)
    extended tile, modelled tile by tile in float32: the owned cells of
    (u, v) after ``nit`` steps (NaN elsewhere), and each step's sums of
    (du)^2 and (dv)^2 over the owned cells, in double."""
    h, w = u.shape
    er, ec = ext
    tr, tc = er - 2 * T, ec - 2 * T
    f32 = np.float32
    u_out, v_out = np.full_like(u, np.nan), np.full_like(v, np.nan)
    sums = np.zeros((nit, 2))
    for oy in range(-T, h - T, tr):
        for ox in range(-T, w - T, tc):
            gy, gx = oy + np.arange(er), ox + np.arange(ec)
            iy = np.flatnonzero((gy >= 0) & (gy < h))
            ix = np.flatnonzero((gx >= 0) & (gx < w))
            ry, cx = np.arange(er), np.arange(ec)
            # "nearest" at the image's edge, the cell itself at the tile's
            rm = np.where(gy == 0, ry, np.maximum(ry - 1, 0))
            rp = np.where(gy == h - 1, ry, np.minimum(ry + 1, er - 1))
            cm = np.where(gx == 0, cx, np.maximum(cx - 1, 0))
            cp = np.where(gx == w - 1, cx, np.minimum(cx + 1, ec - 1))
            hn, hs = (gy > 0)[:, None], (gy < h - 1)[:, None]
            hw, he = (gx > 0)[None, :], (gx < w - 1)[None, :]
            tile, img = np.ix_(iy, ix), np.ix_(gy[iy], gx[ix])
            fl = []
            for a in fields:
                t = np.zeros((er, ec), f32)
                t[tile] = a[img]
                fl.append(t)
            iix, iiy, ii, ixt, iyt, b11, b12, b22 = fl
            su, sv = np.zeros((er, ec), f32), np.zeros((er, ec), f32)
            su[tile], sv[tile] = u[img], v[img]
            inside = np.zeros((er, ec), bool)
            inside[tile] = True
            own = inside.copy()
            own[:T], own[T + tr:], own[:, :T], own[:, T + tc:] = False, False, False, False

            def nb(x, rows, cols):
                return x[np.ix_(rows, cols)]

            def ring(x):
                z = lambda c, m: np.where(m, c, f32(0))  # noqa: E731
                return (((z(nb(x, rm, cm), hn & hw) + z(nb(x, ry, cm), hw))
                         + z(nb(x, rp, cm), hs & hw))
                        + ((z(nb(x, rm, cx), hn) + x) + z(nb(x, rp, cx), hs))
                        + ((z(nb(x, rm, cp), hn & he) + z(nb(x, ry, cp), he))
                           + z(nb(x, rp, cp), hs & he))) - x

            for it in range(nit):
                du1 = (nb(su, rp, cx) - nb(su, rm, cx)) * f32(0.5)
                du2 = (nb(su, ry, cp) - nb(su, ry, cm)) * f32(0.5)
                fu1 = nb(su, rm, cx) + nb(su, rp, cx)
                mu = ((nb(su, rp, cp) - nb(su, rp, cm)) - (nb(su, rm, cp) - nb(su, rm, cm))) \
                    * f32(0.25)
                dv1 = (nb(sv, rp, cx) - nb(sv, rm, cx)) * f32(0.5)
                dv2 = (nb(sv, ry, cp) - nb(sv, ry, cm)) * f32(0.5)
                fv2 = nb(sv, ry, cm) + nb(sv, ry, cp)
                mv = ((nb(sv, rp, cp) - nb(sv, rp, cm)) - (nb(sv, rm, cp) - nb(sv, rm, cm))) \
                    * f32(0.25)
                bu = iix * (f32(2) * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + hreg * ring(su) + ixt
                bv = iiy * (du1 + f32(2) * dv2) + iix * du2 + ii * (mu + fv2) + hreg * ring(sv) + iyt
                un = -(b11 * bu + b12 * bv)
                vn = -(b12 * bu + b22 * bv)
                sums[it] += [np.sum(((un - su)[own]).astype(np.float64) ** 2),
                             np.sum(((vn - sv)[own]).astype(np.float64) ** 2)]
                su, sv = np.where(inside, un, su), np.where(inside, vn, sv)
            keep = np.ix_(gy[own.any(1)], gx[own.any(0)])
            u_out[keep] = su[np.ix_(own.any(1), own.any(0))]
            v_out[keep] = sv[np.ix_(own.any(1), own.any(0))]
    return u_out, v_out, sums


def _ls_blocked_solve(fields, hreg, u0, v0, max_iter, tol, T, ext):
    """The blocked solve through the plan's launches: the stop settled after
    each launch from its steps' errs, the replay of a stop inside a launch
    from that launch's source into its destination."""
    h, w = u0.shape
    plan = LS.launch_plan(max_iter, T)
    bufs = {LS.IN: (u0, v0)}
    k, err, final = 0, np.float32(1e8), LS.IN
    active = max_iter > 0 and np.float32(1e8) > tol
    for j, (nit, dst) in enumerate(plan):
        if not active:
            break
        src = LS.stop_buffers(plan, j)[0]
        u, v, sums = _ls_block_launch(fields, hreg, *bufs[src], nit, T, ext)
        bufs[dst], final = (u, v), dst
        for i in range(nit):
            err = np.float32((np.sqrt(sums[i, 0]) + np.sqrt(sums[i, 1])) / (h * w))
            k += 1
            if not (err > tol and k < max_iter):
                active = False
                if i + 1 < nit:
                    bufs[dst] = _ls_block_launch(fields, hreg, *bufs[src], i + 1, T, ext)[:2]
                break
    return (*bufs[final], k, err)


def _ls_problem(shape, seed=3):
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.uniform(1, 255, shape).astype(np.float32)) for _ in range(2))
    fields = [f.numpy() for f in liu_shen_precompute(a / a.max(), b / b.max(), 10.0)]
    u0, v0 = (rng.uniform(-0.5, 0.5, shape).astype(np.float32) for _ in range(2))
    return fields, u0, v0


def _ls_plain(fields, u0, v0, max_iter, tol):
    return LS.liu_shen_iterate_plain(10.0, [torch.from_numpy(f) for f in fields],
                                     torch.from_numpy(u0), torch.from_numpy(v0), max_iter, tol)


LS_TILES = [((8, 12), 2), ((9, 11), 3), ((32, 64), 6)]


@pytest.mark.parametrize("shape", [(2, 2), (3, 17), (13, 21)])
@pytest.mark.parametrize("ext,T", LS_TILES, ids=["8x12-T2", "9x11-T3", "32x64-T6"])
def test_ls_blocked_model_fixed_count_equals_plain(shape, ext, T):
    """tol = 0: every step runs; max_iter at 0, 1, T-1, T, T+1, 2T+1."""
    fields, u0, v0 = _ls_problem(shape)
    for max_iter in sorted({0, 1, T - 1, T, T + 1, 2 * T + 1}):
        u, v, k, _ = _ls_blocked_solve(fields, np.float32(10.0), u0, v0, max_iter, 0.0, T, ext)
        want = _ls_plain(fields, u0, v0, max_iter, 0.0)
        assert k == int(want[3]) == max_iter
        np.testing.assert_array_equal(u, want[0].numpy())
        np.testing.assert_array_equal(v, want[1].numpy())


@pytest.mark.parametrize("shape", [(2, 2), (3, 17), (13, 21)])
@pytest.mark.parametrize("ext,T", LS_TILES[:2], ids=["8x12-T2", "9x11-T3"])
@pytest.mark.parametrize("where", ["first", "interior", "last"])
def test_ls_blocked_model_stop_equals_plain(shape, ext, T, where):
    """A tol that stops the solve at the first, an interior or the last step
    of the second launch: the state of that step, bit for bit, k equal."""
    if T == 2 and where == "interior":
        T, ext = 3, (9, 11)  # a launch of 2 steps has no interior step
    fields, u0, v0 = _ls_problem(shape)
    k_stop = T + {"first": 1, "interior": 2, "last": T}[where]
    errs = [float(_ls_plain(fields, u0, v0, n, 0.0)[2]) for n in range(1, k_stop + 1)]
    tol = float(np.sqrt(errs[-2] * errs[-1]))
    assert errs[-1] < 0.999 * tol and min(errs[:-1]) > 1.001 * tol
    max_iter = 3 * T + 1
    u, v, k, err = _ls_blocked_solve(fields, np.float32(10.0), u0, v0, max_iter, tol, T, ext)
    want = _ls_plain(fields, u0, v0, max_iter, tol)
    assert k == int(want[3]) == k_stop
    np.testing.assert_array_equal(u, want[0].numpy())
    np.testing.assert_array_equal(v, want[1].numpy())
    np.testing.assert_allclose(err, float(want[2]), rtol=1e-5)


# ---------------------------------------------------------------- Farneback window blur

def _ring(xp, taps, R, nblk):
    """``nblk`` runs of R outputs along the last axis of ``xp`` (which holds
    at least nblk R + n - 1 inputs), as csrc/fb_tile.cuh's slide sums them in
    float32: each thread's ring of R inputs (input i in slot i % R), the taps
    in ascending order from -0."""
    f32 = np.float32
    n = len(taps)
    out = np.empty(xp.shape[:-1] + (nblk * R,), f32)
    for b in range(nblk):
        base = b * R
        ring = [None] * R
        for q in range(R - 1):
            ring[q] = xp[..., base + q]
        acc = [np.full(xp.shape[:-1], -0.0, f32) for _ in range(R)]

        def tap(j, q):
            ring[(q + R - 1) % R] = xp[..., base + j + R - 1]
            t = f32(taps[j])
            for o in range(R):
                acc[o] = acc[o] + ring[(o + q) % R] * t

        j0 = 0
        while j0 + R <= n:
            for q in range(R):
                tap(j0 + q, q)
            j0 += R
        for q in range(R - 1):
            if j0 + q < n:
                tap(j0 + q, q)
        out[..., base:base + R] = np.stack(acc, axis=-1)
    return out


def _slide_pass(x, taps, mode, axis, R):
    """One pass of csrc/fb_blur5_flow.cu along ``axis``, modelled in float32:
    each thread sums R consecutive outputs from a ring of R inputs (``_ring``);
    the border a source index rule, also for the run's outputs past the
    edge."""
    n, half = len(taps), len(taps) // 2
    xs = np.moveaxis(x, axis, -1)
    size = xs.shape[-1]
    nblk = -(-size // R)
    xp = xs[..., _pad_index(size, half, nblk * R + n - 1 - half - size, mode)]
    return np.moveaxis(_ring(xp, taps, R, nblk)[..., :size], -1, axis)


@pytest.mark.parametrize("n", [1, 3, 33, 129])
@pytest.mark.parametrize("mode", ["mirror", "nearest"])
@pytest.mark.parametrize("shape", [(2, 3), (5, 7), (37, 70)])
def test_fb_sliding_pass_equals_correlate1d(n, mode, shape):
    """Both passes (rows, columns) at every tap count the kernel is run
    with, including shapes far smaller than the halo."""
    rng = np.random.default_rng(n)
    taps = rng.uniform(0.01, 1.0, n).astype(np.float32)
    x = rng.normal(0, 100, (5, *shape)).astype(np.float32)
    for axis in (-2, -1):
        got = _slide_pass(x, taps, mode, axis, blur5_flow.OUTPUTS_PER_THREAD)
        want = correlate1d(torch.from_numpy(x), taps, axis=axis, mode=mode).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", ["gaussian", "box"])
def test_fb_sliding_blur_and_solve_equals_plain(window):
    """y-pass, x-pass, the post-scale and the solve against
    ``blur5_flow_plain``: the calibrated 33-tap windows (the box's scale is
    1/33^2)."""
    from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec

    taps, mode, scale = _window_blur_spec(33, window == "gaussian")
    rng = np.random.default_rng(9)
    m = rng.normal(0, 1, (5, 40, 75)).astype(np.float32)
    m[0] += 4.0
    m[2] += 4.0  # a well-conditioned 2x2 system
    R = blur5_flow.OUTPUTS_PER_THREAD
    g = _slide_pass(_slide_pass(m, taps, mode, -2, R), taps, mode, -1, R)
    if scale != 1.0:
        g = g * np.float32(scale)
    got = blur5_flow.update_flow(torch.from_numpy(g))
    want = blur5_flow.blur5_flow_plain(torch.from_numpy(m), taps, mode, scale)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------- Farneback fused loop: schedule

def test_fb_fused_tile_matches_kernel():
    """The tile the wrapper documents and the model walks is the kernels'."""
    tile = (CSRC / "fb_tile.cuh").read_text()
    fused = (CSRC / "fb_fused.cu").read_text()
    assert int(re.search(r"int kTH = (\d+);", tile).group(1)) == fb_fused.TILE_ROWS
    assert int(re.search(r"int kR = (\d+);", tile).group(1)) == blur5_flow.OUTPUTS_PER_THREAD
    assert int(re.search(r"BlurTile<(\d+)>", fused).group(1)) == fb_fused.TILE_COLS
    assert "BlurTile<64>" in (CSRC / "fb_blur5_flow.cu").read_text()


def _tile_blur(m, taps, mode, scale, y0, x0, tile, R):
    """csrc/fb_tile.cuh's blur of the tile at (y0, x0): the source rows and
    columns of its halo by the border rule (the tile's tables), the y-pass
    and the x-pass as rings of R over them, the post-scale."""
    th, tw = tile
    n, half = len(taps), len(taps) // 2
    _, h, w = m.shape
    rows = _pad_index(h, th + n, th + n, mode)[th + n + y0 - half + np.arange(th + n - 1)]
    cols = _pad_index(w, tw + n, tw + n, mode)[tw + n + x0 - half + np.arange(tw + n - 1)]
    slab = m[:, rows][:, :, cols]
    mid = np.swapaxes(_ring(np.swapaxes(slab, 1, 2), taps, R, th // R), 1, 2)
    g = _ring(mid, taps, R, tw // R)
    return g * np.float32(scale) if scale != 1.0 else g


def _fb_persistent(r0, r1, fx0, fy0, n_iters, taps, mode, scale, tile, grid):
    """csrc/fb_fused.cu's schedule in float32: ``grid`` blocks walk the tiles
    (block b takes tiles b, b + grid, ...; the blocks in any order within a
    round); M of the start flow into M_a; each round every tile is blurred
    from M_a, solved, and M of its new flow goes to M_b at the tile's pixels
    (updateMatrices there reads that pixel's flow only: the other pixels'
    are NaN), or, in the last round, the flow; then M_a and M_b swap.  It
    checks that a round never writes the buffer it reads and that each pixel
    of M_b and of the flow is written once a round."""
    th, tw = tile
    _, h, w = r0.shape
    tiles_x = -(-w // tw)
    tiles = tiles_x * -(-h // th)
    if n_iters == 0:
        return fx0.copy(), fy0.copy()

    def um(u, v):
        return tent_sample.update_matrices_plain(
            *(torch.from_numpy(a) for a in (u, v, r0, r1))).numpy()

    m_a = um(fx0, fy0)
    flow = np.full((2, h, w), np.nan, np.float32)
    for it in range(n_iters):
        last = it + 1 == n_iters
        m_b = np.full_like(m_a, np.nan)
        read = m_a.copy()
        writes = np.zeros((h, w), np.int64)
        for b in reversed(range(grid)):
            for t in range(b, tiles, grid):
                y0, x0 = t // tiles_x * th, t % tiles_x * tw
                ys, xs = slice(y0, min(y0 + th, h)), slice(x0, min(x0 + tw, w))
                g = _tile_blur(m_a, taps, mode, scale, y0, x0, tile,
                               blur5_flow.OUTPUTS_PER_THREAD)
                u, v = (a.numpy() for a in blur5_flow.update_flow(
                    torch.from_numpy(g[:, :ys.stop - y0, :xs.stop - x0])))
                writes[ys, xs] += 1
                if last:
                    flow[0, ys, xs], flow[1, ys, xs] = u, v
                else:
                    new = np.full((2, h, w), np.nan, np.float32)
                    new[0, ys, xs], new[1, ys, xs] = u, v
                    m_b[:, ys, xs] = um(new[0], new[1])[:, ys, xs]
        np.testing.assert_array_equal(m_a, read)
        assert bool((writes == 1).all())
        if not last:
            m_a = m_b
    return flow[0], flow[1]


@pytest.mark.parametrize("shape", [(5, 7), (37, 70), (47, 61)])
@pytest.mark.parametrize("n_iters", [0, 1, 3])
@pytest.mark.parametrize("window", ["gaussian", "box"])
@pytest.mark.parametrize("n", [1, 3, 33])
def test_fb_persistent_schedule_equals_plain(shape, n_iters, window, n):
    """The kernel's tile with 3 blocks (fewer blocks than tiles at 37x70,
    more at 5x7 and 47x61) and an 8x16 tile with 3 blocks for many tiles,
    bit for bit against ``fb_fused_plain``."""
    from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec, poly_expansion
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    big = (max(shape[0], 16), max(shape[1], 16))
    im1, im2, _, _ = particle_image_pair(shape=big, seed=5)
    r0, r1 = (poly_expansion(torch.from_numpy(im[:shape[0], :shape[1]].copy()), 7, 1.5)
              .contiguous().numpy() for im in (im1, im2))
    rng = np.random.default_rng(6)
    fx0, fy0 = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    taps, mode, scale = _window_blur_spec(n, window == "gaussian")
    want = fb_fused.fb_fused_plain(*(torch.from_numpy(a) for a in (r0, r1, fx0, fy0)), n_iters,
                                   taps, mode, scale)
    for tile in [(fb_fused.TILE_ROWS, fb_fused.TILE_COLS), (8, 16)]:
        got = _fb_persistent(r0, r1, fx0, fy0, n_iters, taps, mode, scale, tile, 3)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_.numpy())


# ---------------------------------------------------------------- Farneback expansion: tiles

def test_poly_expand_tile_matches_kernel():
    """The tile and the largest n the wrapper documents and the model takes
    are the kernel's."""
    src = (CSRC / "fb_poly_expand.cu").read_text()
    assert int(re.search(r"int kTH = (\d+);", src).group(1)) == poly_expand.TILE_ROWS
    assert int(re.search(r"int kTW = (\d+);", src).group(1)) == poly_expand.TILE_COLS
    assert int(re.search(r"int kMaxN = (\d+);", src).group(1)) == poly_expand.MAX_N


def _sums(x, taps, axis, size):
    """One correlation as the kernel sums it: from -0, each non-zero tap's
    product added in index order."""
    shape = list(x.shape)
    shape[axis] = size
    acc = torch.full(shape, -0.0)
    for j, t in enumerate(taps):
        if t != 0.0:
            acc = acc + x.narrow(axis, j, size) * float(t)
    return acc


def _poly_expand_tiles(srcp, n, sigma, tile):
    """csrc/fb_poly_expand.cu's tiles in float32: each (th, tw) tile staged
    with its n-row and n-column aprons (rows from srcp, clamped at its last;
    columns clamped into the image), the g, xg and xxg sums down every staged
    column, the six sums along the tile's rows, the five combinations, and
    the outputs inside the image written.  Checks that each pixel is written
    once."""
    th, tw = tile
    g, xg, xxg, consts = poly_expand.prepare_poly_gaussian(n, sigma)
    ig11, ig03, ig33, ig55 = (float(c) for c in consts)
    h, w = srcp.shape[0] - 2 * n, srcp.shape[1]
    out = torch.full((5, h, w), float("nan"))
    writes = torch.zeros((h, w), dtype=torch.int64)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rows = torch.arange(y0, y0 + th + 2 * n).clamp(max=h + 2 * n - 1)
            cols = torch.arange(x0 - n, x0 + tw + n).clamp(0, w - 1)
            s = srcp[rows][:, cols]
            ve, vo, vq = (_sums(s, t, 0, th) for t in (g, xg, xxg))
            b1, b2, b4 = (_sums(ve, t, 1, tw) for t in (g, xg, xxg))
            b3, b6 = (_sums(vo, t, 1, tw) for t in (g, xg))
            b5 = _sums(vq, g, 1, tw)
            field = torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                                 b1 * ig03 + b4 * ig33, b6 * ig55])
            ys, xs = slice(y0, min(y0 + th, h)), slice(x0, min(x0 + tw, w))
            out[:, ys, xs] = field[:, :ys.stop - y0, :xs.stop - x0]
            writes[ys, xs] += 1
    assert bool((writes == 1).all())
    return out


POLY_TILES = [(poly_expand.TILE_ROWS, poly_expand.TILE_COLS), (8, 16)]
POLY_BASES = [(7, 1.5), (5, 1.1), (7, 0.3)]  # sigma 0.3: zero and subnormal taps in g's tails


@pytest.mark.parametrize("shape", [(2, 2), (5, 7), (3, 14), (37, 70), (47, 61)])
@pytest.mark.parametrize("n,sigma", POLY_BASES)
def test_poly_expand_tiles_equal_plain(shape, n, sigma):
    """The kernel's tile and an 8x16 one (tiles that straddle every edge;
    images narrower and shorter than 2n + 1) against ``poly_expansion``."""
    from opticalflow_ri_tpu_torch.models.farneback import poly_expansion
    from opticalflow_ri_tpu_torch.ops.padding import pad2d

    if n == 7 and sigma == 0.3:
        g = poly_expand.prepare_poly_gaussian(n, sigma)[0]
        assert (g == 0).any() and ((g != 0) & (np.abs(g) < np.finfo(np.float32).tiny)).any()
    rng = np.random.default_rng(sum(shape) + n)
    im = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    want = poly_expansion(im, n, sigma)
    srcp = pad2d(im, ((n, n), (0, 0)), "nearest")
    for tile in POLY_TILES:
        np.testing.assert_array_equal(_poly_expand_tiles(srcp, n, sigma, tile).numpy(),
                                      want.numpy())


@pytest.mark.parametrize("row0,rows", [(0, 20), (20, 17), (37, 10), (11, 1)],
                         ids=["top", "interior", "bottom", "one-row"])
@pytest.mark.parametrize("n,sigma", POLY_BASES[:2])
def test_poly_expand_stripe_tiles_equal_whole_image(row0, rows, n, sigma):
    """A rows-sharded stripe: n rows of the neighbours' image above and
    below it (the replicate rule's on the image's own border), as
    ``_fb_expansion_local`` hands it over; the model and the plain chain
    equal the whole image's rows."""
    from opticalflow_ri_tpu_torch.models.farneback import poly_expansion
    from opticalflow_ri_tpu_torch.ops.padding import pad2d

    rng = np.random.default_rng(row0 + rows)
    im = torch.from_numpy(rng.uniform(0, 255, (47, 61)).astype(np.float32))
    srcp = pad2d(im, ((n, n), (0, 0)), "nearest")[row0:row0 + rows + 2 * n]
    want = poly_expansion(im, n, sigma)[:, row0:row0 + rows].numpy()
    np.testing.assert_array_equal(poly_expand.poly_expand_plain(srcp, n, sigma).numpy(), want)
    for tile in POLY_TILES:
        np.testing.assert_array_equal(_poly_expand_tiles(srcp, n, sigma, tile).numpy(), want)


def test_poly_expand_takes_the_plain_chain_on_cpu():
    from opticalflow_ri_tpu_torch.models.farneback import poly_expansion

    rng = np.random.default_rng(2)
    im = torch.from_numpy(rng.uniform(0, 255, (19, 23)).astype(np.float32))
    before = poly_expand.poly_expand.launches
    got = poly_expansion(im, 7, 1.5)
    assert poly_expand.poly_expand.launches == before
    assert got.shape == (5, 19, 23) and got.dtype == torch.float32 and got.is_contiguous()
    srcp = torch.cat([im[:1]] * 7 + [im] + [im[-1:]] * 7)
    np.testing.assert_array_equal(got.numpy(), poly_expand.poly_expand_plain(srcp, 7, 1.5).numpy())


@pytest.mark.parametrize("n,rows,match", [(2.5, 20, "odd tap count"), (8, 30, "odd tap count"),
                                          (0, 20, "odd tap count"), (7, 14, "at least 15 rows"),
                                          (5, 10, "at least 11 rows")])
def test_poly_expand_refuses_bad_arguments(n, rows, match):
    """An even tap count 2n + 1 or one under 3, and a source without the
    image's rows: refused on every device.  One past the kernel's 15 taps:
    refused by the kernel's check only, the plain chain computes it."""
    srcp = torch.zeros((rows, 9))
    if n > poly_expand.MAX_N:
        with pytest.raises(ValueError, match=match):
            poly_expand.check_args(srcp, n, poly_expand.MAX_N)
        for fn in (poly_expand.poly_expand, poly_expand.poly_expand_plain):
            assert fn(srcp, n, 1.5).shape == (5, rows - 2 * n, 9)
        return
    for fn in (poly_expand.poly_expand, poly_expand.poly_expand_plain):
        with pytest.raises(ValueError, match=match):
            fn(srcp, n, 1.5)


# ---------------------------------------------------------------- LK GN: the per-pixel exit

def load_kernel_times():
    """scripts/torch_kernel_times.py as a module (it needs no card): the home
    of ``gn_exit`` and ``capture_lk_args``."""
    path = CSRC.parents[1] / "scripts" / "torch_kernel_times.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_times", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GN_EXIT = load_kernel_times().gn_exit


def _gn_exit_model(t1, t2, fields, n_iter, R, hw):
    """csrc/lk_iter.cu's GN loop with its per-pixel exit:
    scripts/torch_kernel_times.py's ``gn_exit``, the one model of it (the
    kernel timer counts a pixel's steps with it).  Returns (px, py, status,
    steps a pixel ran)."""
    return GN_EXIT(lk_iter, t1, t2, *fields, n_iter, R, hw)


def _gn_problem(case, shape=(24, 40), R=5, seed=21):
    """The GN kernel's inputs from lk_kernel_inputs on a rolled noisy pair:
    'calibrated' (|d| <= 4), 'wild' (|d| <= 20), 'singular' (a flat band, so
    windows there are singular), 'bail' (some origins outside the bail
    bounds at step 0) and 'zero' (u0 = +-0 on the column where px0 = 0)."""
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs

    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    if case == "singular":
        a[:, : shape[1] // 2] = 7.0
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    dmax = 20.0 if case == "wild" else 4.0
    u0, v0 = (rng.uniform(-dmax, dmax, shape).astype(np.float32) for _ in range(2))
    if case == "bail":
        u0[::3, ::2] = 70.0
        v0[1::4, 1::3] = -60.0
    if case == "zero":
        u0[:, 13] = 0.0
        u0[::2, 13] = -0.0
    slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(u0), torch.from_numpy(v0),
        max_shift=R)
    t1, t2 = lk_build.lk_build_planes_plain(slab, g_pair, 13, R, runs_y, runs_x)
    return t1, t2, fields


GN_CASES = ["calibrated", "wild", "singular", "bail", "zero"]


@pytest.mark.parametrize("case", GN_CASES)
@pytest.mark.parametrize("n_iter", [0, 1, 5])
def test_lk_gn_exit_model_equals_plain(case, n_iter):
    """Ending a pixel's loop at its first inactive step changes nothing, bit
    for bit; the premises hold on the LK solve's inputs: finite fields and
    planes, and no -0 among the origins."""
    t1, t2, fields = _gn_problem(case)
    for f in (t1, t2, *fields):
        assert bool(torch.isfinite(f).all())
    px0 = fields[6]
    assert not bool(((px0 == 0) & torch.signbit(px0)).any())
    got = _gn_exit_model(t1, t2, fields, n_iter, 5, 13)
    want = lk_iter.lk_gn_iterate_plain(t1, t2, *fields, n_iter, 5, 13)
    for g, w_ in zip(got[:3], want):
        assert torch.equal(g, w_)
        assert not bool(((g == 0) & torch.signbit(g)).any())
    steps = got[3]
    if case == "singular":
        assert bool((steps[fields[5] == 0] == 0).all()) and bool((fields[5] == 0).any())
    if case == "bail" and n_iter:
        assert bool(((steps == 0) & (fields[5] != 0) & (want[2] == 0)).any())
    if case == "zero":
        assert bool((px0[:, 13] == 0).all())  # column 13 plus +-0 minus the half window 13


def test_lk_gn_exit_covers_every_step():
    """Over the cases, pixels end their loop at every step from 0 to 5."""
    seen = set()
    for case in GN_CASES:
        t1, t2, fields = _gn_problem(case)
        seen |= set(_gn_exit_model(t1, t2, fields, 5, 5, 13)[3].unique().tolist())
    assert seen == set(range(6))


# ---------------------------------------------------------------- LK fused: tile and passes

def test_lk_fused_constants_match_kernel():
    text = (CSRC / "lk_iter.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kTile"] == lk_iter.FUSED_TILE
    assert const["kSegY"] == FUSED_SEG_Y
    assert const["kSlots"] == lk_iter.FUSED_SLOTS
    assert "227 * 1024" in text and lk_iter.MAX_SMEM_BYTES == 227 * 1024
    for L in range(1, lk_build.GRID + 1):
        # the kernel's base_width: the least a with a (a + 1) >= L
        a = next(a for a in range(1, L + 1) if a * (a + 1) >= L)
        assert a == base_width(L), L


@pytest.mark.parametrize("R", [1, 2, 5, 6, 7])
def test_lk_fused_plan_partitions_shifts(R):
    size, per, nbytes = lk_iter.fused_plan(R)
    assert size == (8 if R <= 5 else 16)
    assert nbytes <= lk_iter.MAX_SMEM_BYTES
    nplanes = (2 * R + 1) ** 2
    owners = {}
    for rank in range(size):
        mine = (nplanes - rank + size - 1) // size  # the kernel's count
        assert mine <= per
        for j in range(mine):
            owners.setdefault(rank + size * j, []).append((rank, j))
    assert sorted(owners) == list(range(nplanes))
    assert all(len(o) == 1 for o in owners.values())
    with pytest.raises(ValueError, match="do not fit"):
        lk_iter.fused_plan(8)


FUSED_SEG_Y = 16  # y-pass outputs a thread of csrc/lk_iter.cu sums; the x-pass takes a tile row


def _segment_twolevel(x, runs, out_len, seg):
    """csrc/lk_iter.cu's per-thread two-level sum along the last axis of x:
    each thread takes ``seg`` outputs, copies the inputs it needs, forms the
    base box in place (ascending), then adds the b strided base terms and the
    remainder taps re-read from x; run terms added in run order."""
    n_seg = -(-out_len // seg)
    pad = n_seg * seg + lk_build.EXT - x.shape[-1]
    xp = np.concatenate([x, np.zeros(x.shape[:-1] + (max(pad, 0),), np.float32)], axis=-1)
    out = np.zeros(x.shape[:-1] + (n_seg * seg,), np.float32)
    for s0 in range(0, n_seg * seg, seg):
        acc = None
        for lo, hi in runs:
            L = hi - lo + 1
            a = base_width(L)
            b = L // a
            nb = seg + a * (b - 1)
            v = [xp[..., s0 + lo + i].copy() for i in range(nb + a - 1)]
            for i in range(nb):
                s = v[i]
                for j in range(1, a):
                    s = s + v[i + j]
                v[i] = s
            term = []
            for k in range(seg):
                t = v[k]
                for j in range(1, b):
                    t = t + v[k + a * j]
                for j in range(a * b, L):
                    t = t + xp[..., s0 + lo + k + j]
                term.append(t)
            term = np.stack(term, axis=-1)
            acc = term if acc is None else acc + term
        out[..., s0:s0 + seg] = acc
    return out[..., :out_len]


@pytest.mark.parametrize("runs", [((0, 26),), ((0, 7), (9, 26)), ((0, 25),),
                                  ((0, 3), (5, 10), (12, 26), (28, 31)), ((0, 31),), ((4, 4),)],
                         ids=["sym27", "near", "far", "four_runs", "full32", "single"])
@pytest.mark.parametrize("shape", [(5, 7), (32, 32), (33, 70)])
def test_lk_segment_twolevel_equals_wsum(runs, shape):
    """The x-pass a tile row a thread (32 outputs), the y-pass 16 outputs a
    thread, against the two-level window sum."""
    rng = np.random.default_rng(12)
    h, w = shape
    x = rng.normal(0, 100, (h + lk_build.EXT, w + lk_build.EXT)).astype(np.float32)
    t = _segment_twolevel(x, runs, w, lk_iter.FUSED_TILE)
    got = _segment_twolevel(t.T.copy(), runs, h, FUSED_SEG_Y).T
    want = wsum2d(torch.from_numpy(x), runs, runs, 13, h, w, hierarchical=True).numpy()
    np.testing.assert_array_equal(got, want)


def _fused_tile_model(slab, g_pair, R, runs_y, runs_x, size):
    """csrc/lk_iter.cu's build, cluster by cluster: each block of a tile's
    cluster stages the tile's J rows and gradients (0 outside the slab and
    the core), builds its shifts s = rank + size j over the tile's halo with
    the per-thread passes, and keeps them in its own planes.  Returns the
    (nplanes, h, w) stacks read back through the owner rule, and how often
    each (plane, gradient, pixel) of each tile was written."""
    tile = lk_iter.FUSED_TILE
    rows = tile + lk_build.EXT
    nshift = 2 * R + 1
    nplanes = nshift * nshift
    core_h, core_w = g_pair.shape[1:]
    h, w = core_h - lk_build.EXT, core_w - lk_build.EXT
    jn = rows + 2 * R
    th, tw = -(-h // tile), -(-w // tile)
    out = np.full((2, nplanes, th * tile, tw * tile), np.nan, np.float32)
    writes = np.zeros((th, tw, nplanes, 2, tile, tile), np.int64)
    for ty in range(th):
        for tx in range(tw):
            y0, x0 = ty * tile, tx * tile
            J = np.zeros((jn, jn), np.float32)
            src = slab[y0:y0 + jn, x0:x0 + jn]
            J[:src.shape[0], :src.shape[1]] = src
            G = np.zeros((2, rows, rows), np.float32)
            src = g_pair[:, y0:y0 + rows, x0:x0 + rows]
            G[:, :src.shape[1], :src.shape[2]] = src
            for rank in range(size):
                mine = (nplanes - rank + size - 1) // size
                shifts = [rank + size * j for j in range(mine)]
                if not shifts:
                    continue
                P = np.stack([J[s // nshift:s // nshift + rows, s % nshift:s % nshift + rows]
                              for s in shifts])[:, None] * G[None]
                X = _segment_twolevel(P, runs_x, tile, tile)
                Y = np.swapaxes(_segment_twolevel(np.swapaxes(X, -1, -2).copy(), runs_y, tile,
                                                  FUSED_SEG_Y), -1, -2)
                for j, s in enumerate(shifts):
                    for k in range(2):
                        out[k, s, y0:y0 + tile, x0:x0 + tile] = Y[j, k]
                        writes[ty, tx, s, k] += 1
    return out[:, :, :h, :w], writes


@pytest.mark.parametrize("shape,R", [((47, 61), 5), ((47, 61), 2), ((33, 40), 1), ((20, 70), 6)])
def test_lk_fused_tile_model_equals_plain(shape, R):
    """Every (plane, gradient, pixel) of every tile is built by exactly one
    block, the staged halo covers the window at every tile edge (a partial
    last tile included), and the planes equal the plain two-level build."""
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs

    rng = np.random.default_rng(13)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
    z = torch.zeros(shape)
    slab, g_pair, _, runs_y, runs_x = lk_kernel_inputs(torch.from_numpy(a), torch.from_numpy(b),
                                                       z, z, asym=(1, 0, 0, 1), max_shift=R)
    size = lk_iter.fused_plan(R)[0]
    got, writes = _fused_tile_model(slab.numpy(), g_pair.numpy(), R, runs_y, runs_x, size)
    assert bool((writes == 1).all())
    want = lk_build.lk_build_planes_plain(slab, g_pair, 13, R, runs_y, runs_x, hierarchical=True)
    for k in range(2):
        np.testing.assert_array_equal(got[k], want[k].numpy())
