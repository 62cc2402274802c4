"""The port's rows-sharded dense LK and Farneback
(``parallel/sharded_kernel.py``) on four gloo ranks on the CPU, against the
JAX package's sharded functions and the port's single-device solvers.

One group of four ranks is spawned per module (``test_torch_parallel.
spawn_ranks``: children that never import jax): each rank runs the sharded
solves on its ("y", None) stripes, rank 0 gathers them and writes ``.npy``
and the facts (gating, exchange counts) as JSON.  The parent runs the same
inputs, made from numpy seeds, through JAX's ``lk_solve_sharded_kernel``
and ``farneback_solve_sharded`` in interpret mode on a (1, 4, 1) mesh of
the conftest's CPU devices (ports of ``tests/test_sharded_pallas.py:
159-192`` and ``:231-254``), at JAX's own bars: LK bulk > 0.99 within
1e-3, AEE < 1e-3, status equal; FB AEE < 1e-5.  Against the port's
``lk_dense_solve`` and ``farneback_solve`` the sharded results are equal
bit for bit: every pixel is the single-device one given its neighbours'
rows.  The stripes run the kernels' plain versions here (CPU tensors).
"""

import json

import numpy as np
import pytest

from test_torch_parallel import spawn_ranks

_CHILD = r"""
import json, os, sys
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflow_ri_tpu_torch.parallel import distributed as D
from opticalflow_ri_tpu_torch.parallel import (
    exchange_halo, farneback_iterate_sharded, farneback_solve_sharded, fb_shard_supported,
    lk_solve_sharded_kernel, make_mesh, pick_lk_shard_stripe)

D.initialize(init, world, rank, device="cpu")
facts, arrays = {}, {}
lead = rank == 0
rows = ("y", None)
m141 = make_mesh(shape=(1, 4, 1), device_type="cpu")
m411 = make_mesh(shape=(4, 1, 1), device_type="cpu")

def stripes(m, *xs):
    return [torch.as_tensor(x)[D.local_slices(m, x.shape, rows)].contiguous() for x in xs]

def keep(name, m, *tiles):
    for k, t in enumerate(tiles):
        g = D.gather_global(m, t, rows)
        if lead:
            arrays[f"{name}_{k}"] = g.numpy()

def counted(fn):
    before = exchange_halo.exchanges
    res = fn()
    return res, exchange_halo.exchanges - before

def load(name):
    return np.load(os.path.join(out, f"in_{name}.npy"))

def lk_pair(case):
    return [load(f"lk_{case}_{k}") for k in range(4)]

# LK on (1, 4, 1): 48-row stripes, the 38-row apron from both neighbours
for case, asym in (("init_asym", (0, 1, 0, 1)), ("zero_sym", (0, 0, 0, 0))):
    (u, v, s), n = counted(lambda: lk_solve_sharded_kernel(m141, *stripes(m141, *lk_pair(case)),
                                                           asym=asym))
    keep(f"lk_{case}", m141, u, v, s)
    facts[f"lk_{case}_exchanges"] = n
# a y = 1 mesh: every rank holds the whole image
(u, v, s), _ = counted(lambda: lk_solve_sharded_kernel(m411, *stripes(m411, *lk_pair("zero_sym"))))
keep("lk_y1", m411, u, v, s)

# Farneback on (1, 4, 1): 128 x 64, 32-row stripes
a, b, z, _ = (load(f"fb_{k}") for k in range(4))
for name, kw in (("gaussian", {}), ("box", {"use_gaussian": False})):
    (fx, fy), n = counted(lambda: farneback_solve_sharded(m141, *stripes(m141, a, b, z, z), **kw))
    keep(f"fb_{name}", m141, fx, fy)
    facts[f"fb_{name}_exchanges"] = n
(fx, fy), _ = counted(lambda: farneback_solve_sharded(m411, *stripes(m411, a, b, z, z),
                                                      pyr_levels=2))
keep("fb_y1_levels2", m411, fx, fy)

# the gating
facts["pick_lk"] = [pick_lk_shard_stripe(m141, s) for s in ((192, 128), (190, 128), (128, 128))]
facts["pick_lk_y1_thin"] = pick_lk_shard_stripe(m411, (16, 128))
facts["fb_supported"] = [fb_shard_supported(m141, s, 33) for s in ((128, 64), (126, 64), (64, 64))]
facts["fb_supported_small_window"] = fb_shard_supported(m141, (32, 64), 5, R=5)
def raises(fn, kind):
    try:
        fn()
    except kind as err:
        return str(err)
    return None
thin = np.zeros((128, 128), np.float32)
facts["lk_thin_raises"] = raises(
    lambda: lk_solve_sharded_kernel(m141, *stripes(m141, thin, thin, thin, thin)), ValueError)
st = stripes(m141, np.zeros((64, 64), np.float32))[0]
r = torch.zeros((5, *st.shape))
facts["fb_iterate_thin_raises"] = raises(
    lambda: farneback_iterate_sharded(m141, r, r, st, st, 33, True, 1), ValueError)
facts["fb_thin_raises"] = raises(
    lambda: farneback_solve_sharded(m141, *stripes(m141, *(np.zeros((64, 64), np.float32),) * 4)),
    ValueError)
# two levels of 128 x 64 on y = 4: the coarse level's 16-row stripes are
# thinner than the window's 17
facts["fb_levels2_raises"] = raises(
    lambda: farneback_solve_sharded(m141, *stripes(m141, a, b, z, z), pyr_levels=2),
    ValueError)

# the single-device port on rank 0, the references of the bitwise checks
if lead:
    from opticalflow_ri_tpu_torch.models.farneback import farneback_solve
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve
    for case, asym in (("init_asym", (0, 1, 0, 1)), ("zero_sym", (0, 0, 0, 0))):
        for k, t in enumerate(lk_dense_solve(*map(torch.as_tensor, lk_pair(case)), asym=asym)):
            arrays[f"ref_lk_{case}_{k}"] = t.numpy()
    for name, kw in (("gaussian", {}), ("box", {"use_gaussian": False}),
                     ("levels2", {"pyr_levels": 2})):
        for k, t in enumerate(farneback_solve(*map(torch.as_tensor, (a, b, z, z)), **kw)):
            arrays[f"ref_fb_{name}_{k}"] = t.numpy()
    for k, arr in arrays.items():
        np.save(os.path.join(out, k + ".npy"), arr)
    with open(os.path.join(out, "facts.json"), "w") as f:
        json.dump(facts, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_lk_fb")
    out = tmp / "out"
    out.mkdir()
    for case in ("init_asym", "zero_sym"):
        for k, x in enumerate(_lk_pair(case)):
            np.save(out / f"in_lk_{case}_{k}.npy", x)
    for k, x in enumerate(_fb_pair()):
        np.save(out / f"in_fb_{k}.npy", x)
    spawn_ranks(_CHILD, tmp, out)
    with open(out / "facts.json") as f:
        facts = json.load(f)
    return facts, (lambda name: np.load(out / f"{name}.npy"))


def _jax_mesh_y4():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(1, 4, 1), ("batch", "y", "x"))


def _lk_pair(case):
    """LK inputs: the flow init and asymmetric window case of
    tests/test_sharded_pallas.py:159-178, and :119-157's rolled noisy pair
    from zero flow, both at 192 x 128."""
    h, w = 192, 128
    if case == "init_asym":
        rng = np.random.default_rng(4)
        im1 = rng.uniform(0, 255, (h, w)).astype(np.float32)
        im2 = np.roll(im1, (0, 1), axis=(0, 1))
        return im1, im2, np.full((h, w), 0.5, np.float32), np.full((h, w), -0.25, np.float32)
    rng = np.random.default_rng(3)
    im1 = rng.uniform(0, 255, (h, w)).astype(np.float32)
    im2 = (np.roll(im1, (1, 2), axis=(0, 1))
           + rng.normal(0, 2, (h, w)).astype(np.float32)).astype(np.float32)
    z = np.zeros((h, w), np.float32)
    return im1, im2, z, z


def _fb_pair():
    rng = np.random.default_rng(5)
    h, w = 128, 64
    a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    b = (np.roll(a, (1, 2), axis=(0, 1))
         + rng.normal(0, 2, (h, w)).astype(np.float32)).astype(np.float32)
    z = np.zeros((h, w), np.float32)
    return a, b, z, z


# ---------------------------------------------------------------------------
# dense Lucas-Kanade
# ---------------------------------------------------------------------------

def test_lk_sharded_matches_jax_sharded_kernel(ranks):
    """Flow init (0.5, -0.25) and the asymmetric window (0, 1, 0, 1) on
    (1, 4, 1), against JAX's sharded LK kernels in interpret mode."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded_pallas import lk_solve_sharded_kernel

    _, load = ranks
    us, vs, ss = (load(f"lk_init_asym_{k}") for k in range(3))
    ju, jv, js = lk_solve_sharded_kernel(_jax_mesh_y4(), *(jnp.asarray(a)
                                                           for a in _lk_pair("init_asym")),
                                         asym=(0, 1, 0, 1), interpret=True)
    du, dv = np.abs(us - np.asarray(ju)), np.abs(vs - np.asarray(jv))
    assert float(((du < 1e-3) & (dv < 1e-3)).mean()) > 0.99
    assert float(np.mean(np.hypot(du, dv))) < 1e-3
    np.testing.assert_array_equal(ss, np.asarray(js))


@pytest.mark.parametrize("case,ref", [("init_asym", "init_asym"), ("zero_sym", "zero_sym"),
                                      ("y1", "zero_sym")])
def test_lk_sharded_equals_single_device(ranks, case, ref):
    """Against ``lk_dense_solve`` (run on rank 0) bit for bit: on (1, 4, 1),
    and on (4, 1, 1), where every rank holds the whole image."""
    _, load = ranks
    for k in range(3):
        np.testing.assert_array_equal(load(f"lk_{case}_{k}"), load(f"ref_lk_{ref}_{k}"))


@pytest.mark.parametrize("case", ["init_asym", "zero_sym"])
def test_lk_sharded_exchanges_each_image_once(ranks, case):
    assert ranks[0][f"lk_{case}_exchanges"] == 2


def test_lk_shard_pick_gating(ranks):
    """h // my where the rows split and a stripe holds the 38-row apron; a
    y = 1 mesh takes any height."""
    facts, _ = ranks
    assert facts["pick_lk"] == [48, None, None]
    assert facts["pick_lk_y1_thin"] == 16
    assert facts["lk_thin_raises"] and "38 rows" in facts["lk_thin_raises"]


# ---------------------------------------------------------------------------
# Farneback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("gaussian", {}), ("box", {"use_gaussian": False})])
def test_fb_sharded_matches_jax_sharded_kernel(ranks, name, kw):
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded_pallas import farneback_solve_sharded

    _, load = ranks
    fx, fy = (load(f"fb_{name}_{k}") for k in range(2))
    jx, jy = farneback_solve_sharded(_jax_mesh_y4(), *(jnp.asarray(a) for a in _fb_pair()),
                                     interpret=True, **kw)
    aee = float(np.mean(np.hypot(fx - np.asarray(jx), fy - np.asarray(jy))))
    assert aee < 1e-5, aee


@pytest.mark.parametrize("name,ref", [("gaussian", "gaussian"), ("box", "box"),
                                      ("y1_levels2", "levels2")])
def test_fb_sharded_equals_single_device(ranks, name, ref):
    """Against ``farneback_solve`` (run on rank 0) bit for bit; on (4, 1, 1)
    a two-level pyramid runs every level."""
    _, load = ranks
    for k in range(2):
        np.testing.assert_array_equal(load(f"fb_{name}_{k}"), load(f"ref_fb_{ref}_{k}"))


@pytest.mark.parametrize("name", ["gaussian", "box"])
def test_fb_sharded_exchanges_per_level(ranks, name):
    """Blur 2 + expansion 2 + R1 once + M once an iteration (5)."""
    assert ranks[0][f"fb_{name}_exchanges"] == 10


def test_fb_shard_gating(ranks):
    """JAX's conditions: the rows split, and a stripe holds half + 1 rows of
    the window (17 at 33) and R + 1 of the sampler; a thinner stripe
    raises ValueError, at every level of a pyramid (the coarse level named;
    a pyramid that fits runs: tests/test_torch_parallel_route2.py)."""
    facts, _ = ranks
    assert facts["fb_supported"] == [True, False, False]
    assert facts["fb_supported_small_window"] is True
    assert facts["fb_iterate_thin_raises"] and facts["fb_thin_raises"]
    assert facts["fb_levels2_raises"] and "level 1 (scale 0.5)" in facts["fb_levels2_raises"]
