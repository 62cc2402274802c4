"""The seeded pair generator: repeatable, seed-dependent, and with
``utils/synthetic.py:particle_image_pair``'s statistics."""

import numpy as np
import torch

from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair
from pivbench import spec
from pivbench.generator import make_pool
from pivbench.tests._cells import CHECKOUT


def _cfg(size=128):
    cfg = dict(spec.load_cell("ls_hs_512.stream", CHECKOUT / "BENCHMARK.json").config)
    cfg.update(height=size, width=size)
    return cfg


def test_one_seed_gives_one_pool():
    seed = 2**31 + 12345            # beyond 32 signed bits, as the driver's are
    a1, b1, d1 = make_pool(_cfg(), seed, 4, "cpu")
    a2, b2, d2 = make_pool(_cfg(), seed, 4, "cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2) and d1 == d2


def test_seeds_differ_and_pairs_differ():
    a1, _, _ = make_pool(_cfg(), 1, 4, "cpu")
    a2, _, _ = make_pool(_cfg(), 2, 4, "cpu")
    assert not torch.equal(a1, a2)
    assert all(not torch.equal(a1[0], a1[i]) for i in range(1, 4))


def test_statistics_match_particle_image_pair():
    a, b, peaks = make_pool(_cfg(), 7, 8, "cpu")
    ref = [particle_image_pair((128, 128), seed=s) for s in range(8)]
    lit = float((a > 0).float().mean())
    lit_ref = float(np.mean([(r[0] > 0).mean() for r in ref]))
    mean, mean_ref = float(a.mean()), float(np.mean([r[0].mean() for r in ref]))
    assert abs(lit - lit_ref) < 0.1 * lit_ref, (lit, lit_ref)
    assert abs(mean - mean_ref) < 0.2 * mean_ref, (mean, mean_ref)
    assert float(a.max()) == 255.0 and float(a.min()) == 0.0
    assert torch.equal(a, torch.round(a))                   # 8-bit integers
    assert all(1.0 <= d <= 4.0 for d in peaks) and max(peaks) - min(peaks) > 0.5


def test_second_frame_moves_by_the_parabola():
    """Cross-correlating rows of the two frames finds the profile's shift:
    the peak displacement at mid-height, ~0 at the top and bottom."""
    cfg = _cfg(256)
    a, b, peaks = make_pool(cfg, 3, 1, "cpu")

    def shift(rows):
        x = a[0, rows].double()
        y = b[0, rows].double()
        lags = range(-6, 7)
        score = [float((x[:, 6:-6] * torch.roll(y, -s, dims=1)[:, 6:-6]).sum()) for s in lags]
        return list(lags)[int(np.argmax(score))]

    assert abs(shift(slice(118, 138)) - peaks[0]) <= 1.0
    assert shift(slice(0, 12)) == 0 and shift(slice(244, 256)) == 0
