"""The port's sharded pyramid (``auto_sharded_pipeline``'s route 2,
``parallel/context.py`` and the four adapters' kernel-sharded branches) on
four gloo ranks on the CPU, against the JAX package's route 2 and the
port's single-device configurations.

One group of four ranks is spawned per module (``test_torch_parallel.
spawn_ranks``: children that never import jax).  Each rank runs route 2 on
its ("y", "x") tiles of ``particle_image_pair((160, 128), seed=7,
max_disp=3.0)`` (JAX's ``piv_pair_medium``): all 16 route-2 configurations
on a (1, 2, 2) mesh, and the Liu-Shen, LK and Farneback ones on (1, 4, 1),
with call counters on the four sharded solver entries, the halo exchanges,
gathers and K3 calls per configuration.  Rank 0 gathers the flows and
also runs the single-device ``run_config(device="cpu")``.

Bars: against JAX's ``auto_sharded_pipeline(..., kernel_interpret=True)`` on
a (1, 2, 2) mesh of the conftest's CPU devices, JAX's own
(``tests/test_sharded_pallas.py:194-229, 283-317, 382-425``): AEE < 1e-5,
LK bulk > 0.99 within 1e-3.  Against the single-device port AEE <= 5e-6
(a resize on tiles sums its band in another order than the whole-image
matmul); the configurations that resize nothing are equal bit for bit.
The kernel paths run their kernels' plain versions here (CPU tensors).
"""

import json

import numpy as np
import pytest

from test_torch_parallel import spawn_ranks

AEE_BAR = 5e-6

# every configuration but the three single-level HS ones (route 1)
ROUTE2 = ("PyHSchunck_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "denseLK_Fs2_0",
          "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2", "Farneback_Fs0_0",
          "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2", "HS_Fs3_4_PyrLvls2",
          "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0", "LK_Fs2_0_PyrLvls2", "LiuSE_LK_Fs2_0_PyrLvls2",
          "FB_Fs0_0", "FB_Fs0_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2")
# resize nothing: a single level, no warp
BITWISE = ("denseLK_Fs2_0", "LK_Fs2_0", "Farneback_Fs0_0", "FB_Fs0_0")
# the Liu-Shen, LK and Farneback configurations, also run on (1, 4, 1); the
# LK pyramids' coarse level (80 rows) splits into 20-row stripes there,
# thinner than LK's 38-row apron: refused
ROWS = tuple(n for n in ROUTE2 if not n.startswith(("PyHS", "HS_", "LiuSE_PyHS")))
ROWS_REFUSED = ("denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2", "LK_Fs2_0_PyrLvls2")
# the sharded solver entry each configuration's adapters must take
ENTRIES = {
    "PyHSchunck_Fs3_4_PyrLvls2": {"hs"}, "HS_Fs3_4_PyrLvls2": {"hs"},
    "LiuSE_PyHSchunck_Fs3_4_PyrLvls2": {"hs", "ls"},
    "denseLK_Fs2_0": {"lk"}, "denseLK_Fs2_0_PyrLvls2": {"lk"}, "LK_Fs2_0": {"lk"},
    "LK_Fs2_0_PyrLvls2": {"lk"}, "LiuSE_denseLK_Fs2_0_PyrLvls2": {"lk", "ls"},
    "Farneback_Fs0_0": {"fb"}, "Farneback_Fs0_0_PyrLvls2": {"fb"}, "FB_Fs0_0": {"fb"},
    "FB_Fs0_0_PyrLvls2": {"fb"}, "LiuSE_Farneback_Fs0_0_PyrLvls2": {"fb", "ls"},
    "LiuSE_HS_Fs3_4_PyrLvls2": {"ls"}, "LiuSE_LK_Fs2_0_PyrLvls2": {"ls"},
    "LiuSE_FB_Fs0_0_PyrLvls2": {"ls"},
}

# the two-level biLinear=False pyramids: (pre-filter sigma, the adapter
# class of either package, its arguments); the HS adapter's own defaults
# would set biLinear=True, so they are off
LS_WARP_PYRAMIDS = {"hs": (3.4, "HSOpticalFlowAlgoAdapter", ([21.0, 45.0], 100, False)),
                    "ls": (0.0, "LiuShenOpticalFlowAlgoAdapter", (0.1,))}

_CHILD = r"""
import functools, json, os, sys
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
ROUTE2, ROWS = json.loads(sys.argv[5]), json.loads(sys.argv[6])
LS_WARP_PYRAMIDS = json.loads(sys.argv[7])
import numpy as np
import torch
torch.set_num_threads(1)
import opticalflow_ri_tpu_torch
from opticalflow_ri_tpu_torch import LiuShenOpticalFlowAlgoAdapter, generic_pyramidal_optical_flow
from opticalflow_ri_tpu_torch.models.lucas_kanade import evaluate_vorticity_asym
from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
from opticalflow_ri_tpu_torch.ops.warp import liu_shen_warp
from opticalflow_ri_tpu_torch.parallel import distributed as D
from opticalflow_ri_tpu_torch.parallel import (
    exchange_halo, farneback_solve_sharded, gather_axis, kernel_sharded_solvers, make_mesh)
from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk
from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline
from opticalflow_ri_tpu_torch.parallel.sharded_glue import liu_shen_warp_sharded
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

D.initialize(init, world, rank, device="cpu")
facts, arrays = {"calls": {}, "counts": {}, "raises": {}}, {}
lead = rank == 0
yx, rows = ("y", "x"), ("y", None)
m22 = make_mesh(shape=(1, 2, 2), device_type="cpu")
m41 = make_mesh(shape=(1, 4, 1), device_type="cpu")
meshes = {"122": m22, "141": m41}

calls = {}
def counted(key, fn):
    @functools.wraps(fn)
    def run(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return fn(*a, **k)
    return run
for key, attr in (("hs", "hs_solve_sharded_kernel"), ("ls", "liu_shen_solve_sharded_kernel"),
                  ("lk", "lk_solve_sharded_kernel"), ("fb", "farneback_solve_sharded")):
    setattr(sk, attr, counted(key, getattr(sk, attr)))
# K3's wrapper, which the tile warp calls (its launch count stays 0 on the CPU)
warp_tent.warp_pair = counted("warp", warp_tent.warp_pair)

def tiles(m, spec, *xs):
    return [torch.as_tensor(x)[D.local_slices(m, tuple(x.shape), spec)].contiguous() for x in xs]

def keep(name, m, spec, *ts):
    for k, t in enumerate(ts):
        g = D.gather_global(m, t, spec)
        if lead:
            arrays[f"{name}_{k}"] = g.numpy()

im1, im2 = particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]
for mname, names in (("122", ROUTE2), ("141", ROWS)):
    m = meshes[mname]
    a, b = tiles(m, yx, im1, im2)
    for name in names:
        calls.clear()
        before = (exchange_halo.exchanges, gather_axis.gathers)
        try:
            u, v = auto_sharded_pipeline(name, m)(a, b)
        except ValueError as err:
            facts["raises"][f"{name}_{mname}"] = str(err)
            continue
        after = (exchange_halo.exchanges, gather_axis.gathers)
        facts["calls"][f"{name}_{mname}"] = dict(calls)
        facts["counts"][f"{name}_{mname}"] = [x - y for x, y in zip(after, before)]
        keep(f"{name}_{mname}", m, yx, u, v)

# a two-level Farneback solve on 40-row stripes (the coarse level's 20)
fa, fb_, fz = tiles(m41, rows, im1, im2, np.zeros_like(im1))
fx, fy = farneback_solve_sharded(m41, fa, fb_, fz, fz, pyr_levels=2)
keep("fb_levels2", m41, rows, fx, fy)

# the vorticity test on tiles: the global mean, three flows
yy, xx = np.mgrid[0:160, 0:128].astype(np.float32)
flows = {"ccw": (-(yy - 80) * 1e-2, (xx - 64) * 1e-2), "cw": ((yy - 80) * 1e-2, -(xx - 64) * 1e-2),
         "still": (np.zeros_like(xx), np.zeros_like(xx))}
facts["asym"] = {k: list(evaluate_vorticity_asym(*tiles(m22, yx, *f), True, m22))
                 for k, f in flows.items()}

# the biLinear=False (Liu-Shen) warp on tiles, three flows, and the
# two-level biLinear=False driver with each adapter, on both meshes
H, W = im1.shape
frng = np.random.default_rng(11)
warp_flows = {
    "subpixel": (frng.normal(0, 0.6, (H, W)), frng.normal(0, 0.6, (H, W))),
    "integer": (frng.integers(-5, 6, (H, W)), frng.integers(-5, 6, (H, W))),
    "crossing": (70.3 + 3 * frng.normal(size=(H, W)), -90.2 + 3 * frng.normal(size=(H, W)))}
warp_flows = {k: [np.asarray(z, np.float32) for z in f] for k, f in warp_flows.items()}

def pyramid_adapter(name):
    cls, args = LS_WARP_PYRAMIDS[name][1:]
    return getattr(opticalflow_ri_tpu_torch, cls)(*args)

for mname, m in meshes.items():
    for flow, (fu, fv) in warp_flows.items():
        keep(f"lsw_{flow}_{mname}", m, yx, liu_shen_warp_sharded(*tiles(m, yx, im1, fu, fv), m))
    a, b = tiles(m, yx, im1, im2)
    for name in LS_WARP_PYRAMIDS:
        with kernel_sharded_solvers(m):
            keep(f"lsw_pyramid_{name}_{mname}", m, yx, *generic_pyramidal_optical_flow(
                a, b, LS_WARP_PYRAMIDS[name][0], pyramid_adapter(name), pyramidalLevels=2,
                biLinear=False))

# the raises: a biLinear=False warp on tiles narrower than its Gaussian's
# radius (the second level of a 64 x 64 pair on (1, 2, 2)), batch=True
def raised(fn):
    try:
        fn()
    except Exception as err:
        return [type(err).__name__, str(err)]
    return None
def ls_warp():
    a, b = tiles(m22, yx, im1[:64, :64], im2[:64, :64])
    with kernel_sharded_solvers(m22):
        generic_pyramidal_optical_flow(a, b, 0.0, LiuShenOpticalFlowAlgoAdapter(0.1),
                                       pyramidalLevels=2, biLinear=False)
facts["liu_shen_warp"] = raised(ls_warp)
facts["batch"] = raised(lambda: auto_sharded_pipeline("LK_Fs2_0", m22, batch=True))
facts["hs_thin"] = raised(lambda: auto_sharded_pipeline("HS_Fs3_4_PyrLvls2", m22)(
    *tiles(m22, yx, im1[:36, :36], im2[:36, :36])))

if lead:
    from opticalflow_ri_tpu_torch.configs import run_config
    from opticalflow_ri_tpu_torch.models.farneback import farneback_solve
    for name in ROUTE2:
        for k, t in enumerate(run_config(name, im1, im2, device="cpu")):
            arrays[f"ref_{name}_{k}"] = t.numpy()
    z = torch.zeros(im1.shape)
    for k, t in enumerate(farneback_solve(torch.as_tensor(im1), torch.as_tensor(im2), z, z,
                                          pyr_levels=2)):
        arrays[f"ref_fb_levels2_{k}"] = t.numpy()
    facts["asym_single"] = {k: list(evaluate_vorticity_asym(torch.as_tensor(f[0]),
                                                            torch.as_tensor(f[1]), True))
                            for k, f in flows.items()}
    for flow, (fu, fv) in warp_flows.items():
        arrays[f"ref_lsw_{flow}"] = liu_shen_warp(*map(torch.as_tensor, (im1, fu, fv))).numpy()
        arrays[f"flow_{flow}_0"], arrays[f"flow_{flow}_1"] = fu, fv
    for name in LS_WARP_PYRAMIDS:
        for k, t in enumerate(generic_pyramidal_optical_flow(
                im1, im2, LS_WARP_PYRAMIDS[name][0], pyramid_adapter(name), pyramidalLevels=2,
                biLinear=False, device="cpu")):
            arrays[f"ref_lsw_pyramid_{name}_{k}"] = t.numpy()
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
    tmp = tmp_path_factory.mktemp("parallel_route2")
    out = tmp / "out"
    out.mkdir()
    spawn_ranks(_CHILD, tmp, out, json.dumps(ROUTE2), json.dumps(ROWS),
                json.dumps(LS_WARP_PYRAMIDS), timeout=600)
    with open(out / "facts.json") as f:
        facts = json.load(f)
    return facts, (lambda name: np.load(out / f"{name}.npy"))


def _pair():
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    return particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]


def _aee(u, v, ur, vr):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ur), np.asarray(v) - np.asarray(vr))))


# ---------------------------------------------------------------------------
# against JAX's route 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["denseLK_Fs2_0", "Farneback_Fs0_0", "PyHSchunck_Fs3_4_PyrLvls2",
                                  "LiuSE_PyHSchunck_Fs3_4_PyrLvls2"])
def test_route2_matches_jax_route2(ranks, name):
    """``tests/test_sharded_pallas.py:194-229`` (LK), ``:283-317`` (FB) and
    ``:382-425`` (the HS and HS + Liu-Shen pyramids): the port's route 2
    against JAX's, kernels in interpret mode, on (1, 2, 2) meshes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from opticalflow_ri_tpu.parallel import auto

    _, load = ranks
    u, v = load(f"{name}_122_0"), load(f"{name}_122_1")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("batch", "y", "x"))
    im1, im2 = _pair()
    uj, vj = auto.auto_sharded_pipeline(name, mesh, kernel_interpret=True)(jnp.asarray(im1),
                                                                             jnp.asarray(im2))
    uj, vj = np.asarray(uj), np.asarray(vj)
    if "LK" in name:
        bulk = float(((np.abs(u - uj) < 1e-3) & (np.abs(v - vj) < 1e-3)).mean())
        assert bulk > 0.99, bulk
    else:
        assert _aee(u, v, uj, vj) < 1e-5


# ---------------------------------------------------------------------------
# against the single-device port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROUTE2)
def test_route2_equals_single_device(ranks, name):
    """All 16 route-2 configurations on (1, 2, 2) against ``run_config``
    (rank 0, CPU): AEE <= 5e-6; bit for bit where nothing is resized."""
    _, load = ranks
    u, v = load(f"{name}_122_0"), load(f"{name}_122_1")
    ur, vr = load(f"ref_{name}_0"), load(f"ref_{name}_1")
    assert _aee(u, v, ur, vr) <= AEE_BAR
    if name in BITWISE:
        np.testing.assert_array_equal(u, ur)
        np.testing.assert_array_equal(v, vr)


@pytest.mark.parametrize("name", ROWS)
def test_route2_rows_mesh(ranks, name):
    """The Liu-Shen, LK and Farneback configurations on (1, 4, 1): AEE <=
    5e-6 against ``run_config``; the LK pyramids' coarse level is refused
    (20-row stripes, 38 needed) and raises, naming the shape and the
    minimum, with nothing run in its place."""
    facts, load = ranks
    if name in ROWS_REFUSED:
        msg = facts["raises"][f"{name}_141"]
        assert "(20, 64)" in msg and "38 rows" in msg, msg
        return
    u, v = load(f"{name}_141_0"), load(f"{name}_141_1")
    assert _aee(u, v, load(f"ref_{name}_0"), load(f"ref_{name}_1")) <= AEE_BAR
    if name in BITWISE:
        np.testing.assert_array_equal(u, load(f"ref_{name}_0"))
        np.testing.assert_array_equal(v, load(f"ref_{name}_1"))


@pytest.mark.parametrize("name", ROUTE2)
def test_route2_takes_the_sharded_entries(ranks, name):
    """Each adapter routed to its sharded entry (the call counters), and
    the six configurations that warp called K3's wrapper once."""
    facts, _ = ranks
    calls = dict(facts["calls"][f"{name}_122"])
    warps = calls.pop("warp", 0)
    assert set(calls) == ENTRIES[name]
    exchanges, gathers = facts["counts"][f"{name}_122"]
    assert exchanges > 0
    warping = name.startswith(("PyHS", "HS_", "LiuSE_PyHS", "LiuSE_HS", "LiuSE_LK", "LiuSE_FB"))
    assert warps == (1 if warping else 0)
    # the rows-only solvers gather their stripes along x, a pyramid's spline
    # upsample along y and x
    assert gathers > 0


def test_fb_sharded_two_levels_on_y4(ranks):
    """``farneback_solve_sharded(pyr_levels=2)`` on (1, 4, 1), 40-row
    stripes and 20 at the coarse level, against ``farneback_solve``."""
    _, load = ranks
    got = [load(f"fb_levels2_{k}") for k in range(2)]
    ref = [load(f"ref_fb_levels2_{k}") for k in range(2)]
    assert _aee(*got, *ref) <= AEE_BAR


@pytest.mark.parametrize("flow", ["ccw", "cw", "still"])
def test_vorticity_asym_on_tiles(ranks, flow):
    """``evaluate_vorticity_asym(enable=True)`` on a mesh takes the whole
    image's mean vorticity: the single-device tuple."""
    facts, _ = ranks
    assert facts["asym"][flow] == facts["asym_single"][flow]


@pytest.mark.parametrize("case,kind,says", [
    ("liu_shen_warp", "ValueError", "(32, 32)"),
    ("batch", "NotImplementedError", "batch_sharded_scan"),
    ("hs_thin", "ValueError", "(9, 9)")])
def test_route2_raises(ranks, case, kind, says):
    """No fallback: the biLinear=False warp on tiles narrower than its
    Gaussian's 36-cell radius (the second level of a 64 x 64 pair on (1, 2,
    2)), ``batch=True``, and HS tiles too small for the kernel's T-block
    (the coarse level of a 36 x 36 image on (1, 2, 2)) raise."""
    got = ranks[0][case]
    assert got is not None and got[0] == kind and says in got[1], got
    if case == "liu_shen_warp":
        assert "36 cells" in got[1], got


# ---------------------------------------------------------------------------
# the biLinear=False (Liu-Shen) warp on tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", ["122", "141"])
@pytest.mark.parametrize("flow", ["subpixel", "integer", "crossing"])
def test_liu_shen_warp_on_tiles_equals_whole_image(ranks, flow, mname):
    """``liu_shen_warp_sharded`` on (1, 2, 2) and (1, 4, 1) tiles (80 x 64
    and 40 x 128) gathered: the single-device ``liu_shen_warp`` bit for
    bit, for a sub-pixel flow, integer flows of |d| <= 5 (collisions, and
    negative flows on the top and left border that wrap to another rank's
    tile) and a flow of (70, -90) px that crosses whole tiles."""
    _, load = ranks
    np.testing.assert_array_equal(load(f"lsw_{flow}_{mname}_0"), load(f"ref_lsw_{flow}"))
    fu, fv = load(f"flow_{flow}_0"), load(f"flow_{flow}_1")
    ui, vi = np.floor(fu + 0.5), np.floor(fv + 0.5)
    ys, xs = np.mgrid[0:fu.shape[0], 0:fu.shape[1]]
    if flow == "integer":   # destinations above and left of the image wrap
        assert (ys + vi < 0).any() and (xs + ui < 0).any()
    if flow == "crossing":
        assert np.abs(vi).mean() > 80 and np.abs(ui).mean() > 64


@pytest.mark.parametrize("mname", ["122", "141"])
@pytest.mark.parametrize("name", ["hs", "ls"])
def test_bilinear_false_pyramid_equals_single_device(ranks, name, mname):
    """The two-level ``biLinear=False`` driver under ``kernel_sharded_solvers``
    with an HS ([21, 45], 100 iterations, sigma 3.4) and a Liu-Shen (h 0.1)
    adapter, on (1, 2, 2) and (1, 4, 1), against the single-device port:
    AEE <= 5e-6."""
    _, load = ranks
    got = [load(f"lsw_pyramid_{name}_{mname}_{k}") for k in range(2)]
    ref = [load(f"ref_lsw_pyramid_{name}_{k}") for k in range(2)]
    assert _aee(*got, *ref) <= AEE_BAR


@pytest.mark.parametrize("name", ["hs", "ls"])
def test_bilinear_false_pyramid_matches_jax(ranks, name):
    """The same pyramids against JAX's driver jitted over a (1, 2, 2) mesh
    of the conftest's CPU devices under ``kernel_sharded_solvers(mesh,
    True)`` and ``force_xla()``, as its route 2 runs: AEE < 1e-5, JAX's
    route-2 bar."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import opticalflow_ri_tpu
    from opticalflow_ri_tpu.ops.pallas import force_xla
    from opticalflow_ri_tpu.parallel.context import kernel_sharded_solvers

    _, load = ranks
    sigma, cls, args = LS_WARP_PYRAMIDS[name]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("batch", "y", "x"))
    tiled = NamedSharding(mesh, P("y", "x"))

    def run(a, b):
        a, b = (jax.lax.with_sharding_constraint(t, tiled) for t in (a, b))
        with force_xla(), kernel_sharded_solvers(mesh, True):
            u, v = opticalflow_ri_tpu.generic_pyramidal_optical_flow(
                a, b, sigma, getattr(opticalflow_ri_tpu, cls)(*args), pyramidalLevels=2,
                biLinear=False)
        return tuple(jax.lax.with_sharding_constraint(t, tiled) for t in (u, v))

    im1, im2 = _pair()
    uj, vj = (np.asarray(t) for t in jax.jit(run, in_shardings=(tiled, tiled))(
        jnp.asarray(im1), jnp.asarray(im2)))
    assert _aee(load(f"lsw_pyramid_{name}_122_0"), load(f"lsw_pyramid_{name}_122_1"),
                uj, vj) < 1e-5
