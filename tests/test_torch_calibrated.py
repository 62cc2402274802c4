"""Calibrated names ``"<config>@<bits>/<ni>"``: the port's registry runs the
three ``_hs`` configurations on any row of the h-table.

The registry: every row's alphas against the JAX package's ``hs_alphas``,
the names and rows it refuses, the unchanged set of plain names, and
``parallel.auto``'s routing by base name.  The pipeline: a small non-square
12-bit pair rendered as the benchmark renders its frames, through the
port's plain path, against the JAX package's pyramid built with the same
alphas (the whole-pipeline bar) and against the benchmark's plain
reference (``pivbench/reference``) with the configuration's recipe.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalflow_ri_tpu import configs as jcfg
from opticalflow_ri_tpu.models import horn_schunck as jhs

from opticalflow_ri_tpu_torch import configs as tcfg
from opticalflow_ri_tpu_torch.compile import compiled_pipeline, pipeline_fn, scan_pipeline
from opticalflow_ri_tpu_torch.parallel import auto, sharded_glue, sharded_kernel
from pivbench.generator import make_pool
from pivbench.reference import pipeline as reference_pipeline
from conftest import aee

AEE_BAR = 5e-6        # the whole-pipeline bar against the JAX package
# the reference against the port: the round-off of 1200 Jacobi iterations,
# 120 Liu-Shen steps and the resizes' products on 12-bit frames
REF_AEE_BAR = 1e-6
CONFIG = Path(__file__).resolve().parents[1] / "pivbench" / "configs" / "ls_hs12_2560x2160.json"
ROWS = sorted(tcfg.HS_H_TABLE)
CASES = [(base, row) for base in tcfg.HS_CALIBRATED for row in ROWS]


def _name(base, row):
    return f"{base}@{row[0]}/{row[1]}"


@pytest.fixture(autouse=True)
def _one_thread():
    """The torch parts run fastest on one thread beside other work."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("base,row", CASES, ids=[_name(b, r) for b, r in CASES])
def test_calibrated_alphas_are_the_jax_tables(base, row):
    cfg = tcfg.build_config(_name(base, row))
    plain = tcfg.CONFIGS[base]
    levels = plain.pyr_levels
    main = cfg.main()
    assert main.alphas == jcfg.hs_alphas(levels, 1, *row) == list(jcfg.HS_H_TABLE[row][:levels])
    assert main.Niter == plain.main().Niter == 600
    assert cfg.name == _name(base, row)
    assert (cfg.filter_sigma, cfg.pyr_levels, cfg.k_levels, cfg.filter_opt, cfg.kwargs) == (
        plain.filter_sigma, plain.pyr_levels, plain.k_levels, plain.filter_opt, plain.kwargs)
    assert cfg.optional is plain.optional
    # a fresh adapter a run: the alpha list starts full each time
    assert cfg.main().alphas == main.alphas and cfg.main() is not main


def test_plain_names_are_unchanged():
    assert set(tcfg.CONFIGS) == set(jcfg.CONFIGS)
    assert not [n for n in tcfg.CONFIGS if "@" in n]
    for base in tcfg.HS_CALIBRATED:
        assert tcfg.build_config(base) is tcfg.CONFIGS[base]
        assert tcfg.build_config(base).main().alphas == jcfg.hs_alphas(
            tcfg.CONFIGS[base].pyr_levels)
        assert tcfg.build_config(_name(base, ("Bits08", "Ni06"))).main().alphas == \
            tcfg.CONFIGS[base].main().alphas
    assert tcfg.build_config("LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06").main().alphas == [
        325, 920]


@pytest.mark.parametrize("name,match", [
    ("LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits14/Ni06", "no h-table row"),
    ("PyHSchunck_Fs3_4@Bits12/Ni07", "no h-table row"),
    ("PyHSchunck_Fs3_4@Bits12", "no h-table row"),
    ("PyHSchunck_Fs3_4@Bits12/Ni06/x", "no h-table row"),
    ("PyHSchunck_Fs3_4@", "no h-table row"),
    ("HS_Fs3_4@Bits12/Ni06", "a calibrated name runs one of"),
    ("FB_Fs0_0_PyrLvls2@Bits12/Ni06", "a calibrated name runs one of"),
    ("LiuSE_HS_Fs3_4_PyrLvls2@Bits12/Ni06", "a calibrated name runs one of"),
    ("PyHSchunck_Fs3_4_PyrLvls9@Bits12/Ni06", "a calibrated name runs one of"),
    ("PyHSchunck_Fs3_4/Bits12/Ni06", "unknown config"),       # a calibration needs the "@"
])
def test_calibrated_names_that_are_refused(name, match):
    with pytest.raises(KeyError, match=match):
        tcfg.build_config(name)
    with pytest.raises(KeyError, match="unknown config"):
        pipeline_fn(name)


def test_refusals_name_the_choices():
    with pytest.raises(KeyError) as e:
        tcfg.build_config("PyHSchunck_Fs3_4@Bits16/Ni06")
    assert all(f"{b}/{n}" in str(e.value) for b, n in tcfg.HS_H_TABLE)
    with pytest.raises(KeyError) as e:
        tcfg.build_config("HS_Fs3_4@Bits12/Ni06")
    assert all(base in str(e.value) for base in tcfg.HS_CALIBRATED)


@pytest.fixture
def route1(monkeypatch):
    """``parallel.auto``'s route 1 with the collectives taken out: a one-tile
    mesh, the T-block fixed, and the sharded HS solve recording what it was
    handed."""
    seen = []

    def solve(a, b, u, v, mesh, alpha, niter, t_block):
        seen.append((alpha, niter, t_block))
        return u, v, None

    monkeypatch.setattr(auto, "axis_size", lambda mesh, axis: 1)
    monkeypatch.setattr(sharded_kernel, "pick_hs_shard_t", lambda mesh, shape: 8)
    monkeypatch.setattr(sharded_kernel, "_hs_body_shardkernel", solve)
    monkeypatch.setattr(sharded_glue, "prefilter_sharded", lambda x, sigma, n, mesh: x)
    return seen


@pytest.mark.parametrize("row", [("Bits08", "Ni06"), ("Bits10", "Ni06"), ("Bits12", "Ni06")])
def test_auto_routes_a_calibrated_name_as_its_base(route1, row, monkeypatch):
    name = _name("PyHSchunck_Fs3_4", row)
    assert auto.hs_kernel_sharded_eligible(name, None, (64, 64)) == 8
    assert auto.hs_kernel_sharded_eligible("PyHSchunck_Fs3_4", None, (64, 64)) == 8
    for two_levels in ("PyHSchunck_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2"):
        assert auto.hs_kernel_sharded_eligible(_name(two_levels, row), None, (64, 64)) is None
    a = torch.zeros(8, 8)
    auto.sharded_pipeline_fn(name, None)(a, a)
    auto.sharded_pipeline_fn("PyHSchunck_Fs3_4", None)(a, a)
    assert route1 == [(tcfg.HS_H_TABLE[row][0], 600, 8), (21.0, 600, 8)]
    # the two-level configs take route 2, the whole config on the tiles
    pyramids = []
    monkeypatch.setattr(auto, "_pyramid_sharded", lambda n, mesh: pyramids.append(n))
    auto.sharded_pipeline_fn(_name("LiuSE_PyHSchunck_Fs3_4_PyrLvls2", row), None)
    assert pyramids == [_name("LiuSE_PyHSchunck_Fs3_4_PyrLvls2", row)]


def _frames(shape, seed, bits=12):
    """A pair rendered as the benchmark renders its frames, at ``bits``."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(height=shape[0], width=shape[1], bit_depth=bits)
    a, b, _ = make_pool(cfg, seed, 1, torch.device("cpu"))
    return a[0].numpy(), b[0].numpy()


@pytest.fixture(scope="module")
def pair12():
    im1, im2 = _frames((48, 64), 2**31 + 3)
    assert im1.max() == 4095.0 or im2.max() == 4095.0
    return im1, im2


@pytest.mark.parametrize("base", tcfg.HS_CALIBRATED)
def test_calibrated_pipeline_matches_jax(base, pair12):
    im1, im2 = pair12
    name = _name(base, ("Bits12", "Ni06"))
    jc = jcfg.CONFIGS[base]
    levels = jc.pyr_levels
    jc = dataclasses.replace(jc, main=lambda: jhs.HSOpticalFlowAlgoAdapter(
        jcfg.hs_alphas(levels, 1, "Bits12", "Ni06"), 600))
    ju, jv = jc.run(im1, im2)
    tu, tv = tcfg.run_config(name, im1, im2, device="cpu")
    assert tu.shape == im1.shape and tu.dtype == torch.float32
    assert aee(tu.numpy(), tv.numpy(), np.asarray(ju), np.asarray(jv)) <= AEE_BAR
    # the calibration is what moved the flow: the Bits08 alphas give another one
    pu, pv = tcfg.run_config(base, im1, im2, device="cpu")
    assert aee(tu.numpy(), tv.numpy(), pu.numpy(), pv.numpy()) > 100 * AEE_BAR


@pytest.mark.parametrize("shape", [(48, 64), (36, 56)])
def test_calibrated_pipeline_matches_the_reference(shape):
    cfg = json.loads(CONFIG.read_text())
    pairs = [_frames(shape, 2**31 + s) for s in (5, 6)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    u, v, tally = reference_pipeline(a, b, cfg["pipeline"])
    h, w = shape
    assert [(t["stage"], t["shape"]) for t in tally] == [
        ("hs_iterate", (h // 2, w // 2)), ("ls_iterate", (h // 2, w // 2)),
        ("hs_iterate", (h, w)), ("ls_iterate", (h, w))]
    for i, (im1, im2) in enumerate(pairs):
        pu, pv = tcfg.run_config(cfg["registry"], im1, im2, device="cpu")
        assert float(torch.hypot(u[i] - pu, v[i] - pv).mean()) < REF_AEE_BAR
        assert float(torch.hypot(pu, pv).mean()) > 0.3      # a flow, not zeros


def test_entries_take_a_calibrated_name(pair12):
    """``compiled_pipeline`` and ``scan_pipeline`` run a calibrated name on the
    CPU's eager path, equal to ``run_config`` and cached under the name."""
    im1, im2 = pair12
    name = "LiuSE_PyHSchunck_Fs3_4_PyrLvls2@Bits12/Ni06"
    want = tcfg.run_config(name, im1, im2, device="cpu")
    got = compiled_pipeline(name)(im1, im2, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert compiled_pipeline(name).name == name and compiled_pipeline(name) is compiled_pipeline(name)
    us, vs = scan_pipeline(name)(im1[None], im2[None], device="cpu")
    assert torch.equal(us[0], want[0]) and torch.equal(vs[0], want[1])
