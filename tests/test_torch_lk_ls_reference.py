"""The benchmark's plain dense-LK reference (``pivbench/reference/
lucas_kanade.py``) against the NumPy oracle's literal per-pixel loop, the
``lk_ls_1024`` recipe of the reference against the port's plain CPU path,
and the reference's tally of Gauss-Newton steps against a count of the
steps themselves."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu.oracle.lucas_kanade import lk_dense
from opticalflow_ri_tpu.utils.synthetic import particle_image_pair

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve
from pivbench.reference import glue, pipeline
from pivbench.reference import lucas_kanade as ref

CONFIG = Path(__file__).resolve().parents[1] / "pivbench" / "configs" / "lk_ls_1024.json"
LK_BAR = 1.2e-4     # PARITY.md's LK bar on u, v: the shift planes sum the window in another order
# The reference sums each window and blends the planes in the port's order, so
# the recipe's only round-off left is that of the resizes' matrix products on
# a block of pairs against one pair (0 on this CPU); the max bar leaves room
# for one Gauss-Newton exit flipped by it, which Liu-Shen smooths.
AEE_BAR = 1e-6
MAX_BAR = 1e-4


def _pair(shape, seed):
    im1, im2, ut, vt = particle_image_pair(shape=shape, seed=seed, max_disp=2.5)
    return im1, im2, ut, vt


@pytest.mark.parametrize("shape,seed", [((47, 61), 1), ((64, 64), 2), ((64, 64), 3)])
@pytest.mark.parametrize("start", ["zero", "true_half"])
def test_reference_lk_matches_the_oracle(shape, seed, start):
    im1, im2, ut, vt = _pair(shape, seed)
    if start == "zero":
        u0 = v0 = np.zeros_like(im1)
    else:
        u0, v0 = (ut * 0.5).astype(np.float32), (vt * 0.5).astype(np.float32)
    ou, ov, _, _ = lk_dense(im1, im2, u0, v0, calc_err=False)
    assert max(np.abs(ou).max(), np.abs(ov).max()) < 5.0     # inside the clamp of R = 5
    u, v, steps = ref.solve(*(torch.from_numpy(x)[None] for x in (im1, im2, u0, v0)))
    assert np.abs(u[0].numpy() - ou).max() <= LK_BAR
    assert np.abs(v[0].numpy() - ov).max() <= LK_BAR
    assert 1.0 <= float(steps[0]) <= 5.0


@pytest.mark.parametrize("half_window", [2, 3, 7, 8, 13, 15])
def test_window_is_the_kernels(half_window):
    from opticalflow_ri_tpu.oracle.lucas_kanade import window_mask

    n = ref.window_length(half_window)
    want = np.zeros(32, np.float32)
    want[:n] = 1.0
    np.testing.assert_array_equal(window_mask(2 * half_window + 1, 0, 0), want)


@pytest.mark.parametrize("shape", [(64, 64), (96, 128)])
def test_recipe_matches_the_port_cpu(shape):
    torch.set_num_threads(1)
    cfg = json.loads(CONFIG.read_text())
    pairs = [particle_image_pair(shape, seed=s, max_disp=2.0) for s in (0, 1, 2)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    u, v, tally = pipeline(a, b, cfg["pipeline"])
    h, w = shape
    assert [(t["stage"], t["shape"]) for t in tally] == [
        (s, (h // 2, w // 2)) for s in ("lk_build", "lk_iterate", "ls_iterate")] + [
        (s, (h, w)) for s in ("lk_build", "lk_iterate", "ls_iterate")]
    for i, (im1, im2, _, _) in enumerate(pairs):
        pu, pv = run_config(cfg["registry"], im1, im2, device="cpu")
        assert float(torch.hypot(u[i] - pu, v[i] - pv).mean()) <= AEE_BAR
        assert float(torch.maximum((u[i] - pu).abs().max(), (v[i] - pv).abs().max())) <= MAX_BAR
        assert float(torch.hypot(pu, pv).mean()) > 0.3      # a flow, not zeros


def test_tally_counts_the_steps_the_exit_left():
    """Each pixel's steps counted from the port's solve stopped after k = 1..5
    steps: a step ran where the origin moved.  Their mean over the pixels is
    the tally's ``lk_iterate`` count of each pair and level."""
    im1, im2, ut, vt = _pair((48, 64), 5)
    a, b = torch.from_numpy(im1), torch.from_numpy(im2)
    starts = [(torch.zeros_like(a), torch.zeros_like(a)),
              (torch.from_numpy(ut * 0.5).float(), torch.from_numpy(vt * 0.5).float())]
    tally = []
    solver = ref.Solver({"half_window": 13, "n_iter": 5, "max_shift": 5}, 1,
                        glue.PRECISIONS["fp32"])
    for u0, v0 in starts:
        solver.compute(a[None], b[None], u0[None], v0[None], tally)
        steps = torch.zeros_like(a)
        prev = lk_dense_solve(a, b, u0, v0, n_iter=0)[:2]
        for k in range(1, 6):
            now = lk_dense_solve(a, b, u0, v0, n_iter=k)[:2]
            steps += ((now[0] != prev[0]) | (now[1] != prev[1])).float()
            prev = now
        assert tally[-2] == {"stage": "lk_build", "shape": (48, 64), "counts": [1]}
        assert tally[-1]["stage"] == "lk_iterate"
        assert tally[-1]["counts"][0] == pytest.approx(float(steps.mean()), abs=1e-6)
        assert 1.0 < float(steps.mean()) < 5.0
