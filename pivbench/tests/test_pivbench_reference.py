"""The plain reference against the port's plain CPU path at small sizes.

The reference imports nothing of the port; this test does, to hold the two
together: the same pipeline on the same pairs agrees to float32 round-off.
"""

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu_torch.configs import run_config
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair
from pivbench import spec
from pivbench.reference import pipeline
from pivbench.tests._cells import CHECKOUT


def _pairs(shape, seeds):
    pairs = [particle_image_pair(shape, seed=s, max_disp=2.0) for s in seeds]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])),
            torch.from_numpy(np.stack([p[1] for p in pairs])), pairs)


def _recipe(config):
    return spec.load_cell(f"{config}.stream", CHECKOUT / "BENCHMARK.json").config


# AEE bars: the round-off of 1200 Jacobi iterations and 120 Liu-Shen steps
# (measured ~2e-8), and of Farnebäck's sampling order (measured ~9e-8)
@pytest.mark.parametrize("config,shape,bar", [("ls_hs_512", (64, 64), 1e-6),
                                              ("ls_hs_512", (48, 80), 1e-6),
                                              ("fb_2048", (96, 80), 1e-6)])
def test_reference_matches_port_cpu(config, shape, bar):
    torch.set_num_threads(1)
    cfg = _recipe(config)
    a, b, pairs = _pairs(shape, (0, 1))
    u, v, tally = pipeline(a, b, cfg["pipeline"])
    for i, (im1, im2, _, _) in enumerate(pairs):
        pu, pv = run_config(cfg["registry"], im1, im2, device="cpu")
        aee = float(torch.hypot(u[i] - pu, v[i] - pv).mean())
        assert aee < bar, (config, i, aee)
        assert float(torch.hypot(pu, pv).mean()) > 0.3   # a flow, not zeros


def test_reference_counts_work():
    cfg = _recipe("ls_hs_512")
    a, b, _ = _pairs((32, 32), (3, 4))
    _, _, tally = pipeline(a, b, cfg["pipeline"])
    stages = [(t["stage"], t["shape"]) for t in tally]
    assert stages == [("hs_iterate", (16, 16)), ("ls_iterate", (16, 16)),
                      ("hs_iterate", (32, 32)), ("ls_iterate", (32, 32))]
    assert tally[0]["counts"] == [600, 600]
    assert all(1 <= k <= 60 for t in tally[1::2] for k in t["counts"])
    fb = _recipe("fb_2048")
    _, _, tally = pipeline(a, b, fb["pipeline"])
    assert [(t["stage"], t["shape"], t["counts"], t["params"]) for t in tally] == [
        ("fb_iterate", (16, 16), [5, 5], {"taps": 33}), ("fb_iterate", (32, 32), [5, 5], {"taps": 33})]


def test_liu_shen_stops_per_pair():
    """A pair whose err falls under tol stops there; the others run on, and
    each ends as its own unbatched solve."""
    from pivbench.reference import liu_shen

    a, b, _ = _pairs((24, 24), (5, 6))
    z = torch.zeros_like(a)
    _, _, k_all = liu_shen.solve(a, b, 5.0, z, z, 60, 0.0)
    u1, v1, k1 = liu_shen.solve(a[:1], b[:1], 5.0, z[:1], z[:1], 60, 1e-3)
    u, v, k = liu_shen.solve(a, b, 5.0, z, z, 60, 1e-3)
    assert k_all.tolist() == [60, 60]
    assert k[0] == k1[0] < 60
    torch.testing.assert_close(u[0], u1[0], rtol=0, atol=1e-6)
