"""The sharded pyramid's glue (``parallel/sharded_glue.py``) and K3's
caller-padded mode (``ops/cuda/warp_tent.py``) on the CPU.

K3's plain version in its padded mode, on tiles of a 47x61 and a 160x128
image under each of the 16 combinations of border and interior sides,
equals the whole-image call cropped to the tile bit for bit; the
whole-image call still equals the JAX package's ``displacement_warp_tent``.

One group of four gloo ranks (``test_torch_parallel.spawn_ranks``) runs the
tile forms of the resizes, the warp and ``gather_axis`` on (1, 2, 2) and
(1, 4, 1) meshes; rank 0 gathers them.  The resizes are held to 1e-6
relative (to the field's largest magnitude) against the port's
``pil_resize`` / ``spline_upsample`` and the JAX package's
``ops/resize.py``: a product over a sliced band or a gathered K may add in
another order.  The warp and the gathers are bit for bit.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from test_torch_parallel import spawn_ranks

from opticalflow_ri_tpu_torch.ops.cuda import warp_tent as tk
from opticalflow_ri_tpu_torch.ops.padding import pad2d

REL = 1e-6
APRON = 8   # K3's reach at max_shift 8: floor(d) in [-8, 7], the second tap at +1

# ---------------------------------------------------------------------------
# K3's caller-padded mode (plain version)
# ---------------------------------------------------------------------------


def _warp_inputs(shape, dmax, seed):
    rng = np.random.default_rng(seed)
    ims = [torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)) for _ in range(2)]
    flows = [torch.from_numpy(rng.uniform(-dmax, dmax, shape).astype(np.float32))
             for _ in range(4)]
    return ims, flows


# (top, bottom, left, right): True where the side is the image's border
SIDES = list(itertools.product((True, False), repeat=4))


def _tile_box(shape, sides):
    """A tile whose sides are the image's border where ``sides`` says so,
    and interior (cells of the image beyond them) elsewhere."""
    h, w = shape
    top, bottom, left, right = sides
    return (0 if top else 13, h if bottom else h - 11, 0 if left else 9, w if right else w - 17)


@pytest.mark.parametrize("shape", [(47, 61), (160, 128)])
@pytest.mark.parametrize("dmax", [4.0, 12.0])
def test_padded_warp_equals_whole_image_cropped(shape, dmax):
    """Under each of the 16 side combinations, the padded call (the image's
    "nearest" apron of 8 cells cut around the tile, as the exchange gives
    it) equals the whole-image call's cells of the tile, bit for bit; a
    flow beyond R = 8 (``dmax`` 12) is clamped in both."""
    (im1, im2), flows = _warp_inputs(shape, dmax, seed=int(dmax))
    whole = tk.warp_pair(im1, im2, *flows)
    padded = [pad2d(im, APRON, "nearest") for im in (im1, im2)]
    for sides in SIDES:
        r0, r1, c0, c1 = _tile_box(shape, sides)
        tiles = [p[r0:r1 + 2 * APRON, c0:c1 + 2 * APRON].contiguous() for p in padded]
        got = tk.warp_pair(*tiles, *(f[r0:r1, c0:c1] for f in flows), apron=APRON, row0=r0,
                           col0=c0, img_h=shape[0], img_w=shape[1])
        for g, want in zip(got, whole):
            assert torch.equal(g, want[r0:r1, c0:c1]), (shape, sides)


def test_padded_warp_refuses_a_short_apron():
    """An interior side whose apron is narrower than the taps' reach, or
    an image that does not hold the flow and its apron, raises."""
    (im1, im2), flows = _warp_inputs((47, 61), 4.0, seed=0)
    box = _tile_box((47, 61), (False, False, False, False))
    r0, r1, c0, c1 = box
    tiles = [pad2d(im, 4, "nearest")[r0:r1 + 8, c0:c1 + 8].contiguous() for im in (im1, im2)]
    cut = [f[r0:r1, c0:c1] for f in flows]
    with pytest.raises(ValueError, match="reach"):
        tk.warp_pair(*tiles, *cut, apron=4, row0=r0, col0=c0, img_h=47, img_w=61)
    with pytest.raises(ValueError, match="does not hold"):
        tk.warp_pair(*tiles, *cut, apron=APRON, row0=r0, col0=c0, img_h=47, img_w=61)


@pytest.mark.parametrize("shape", [(47, 61), (160, 128)])
def test_whole_image_warp_equals_jax(shape):
    """The whole-image call (no apron, origin 0) against JAX
    ``ops/warp.py:69`` ``displacement_warp_tent``, bit for bit."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.ops import warp as jwarp

    (im1, _), flows = _warp_inputs(shape, 6.0, seed=3)
    got = tk.displacement_warp_tent(im1, flows[0], flows[1], 8, apron=0, row0=0, col0=0)
    want = np.asarray(jwarp.displacement_warp_tent(jnp.asarray(im1.numpy()),
                                                   jnp.asarray(flows[0].numpy()),
                                                   jnp.asarray(flows[1].numpy()), 8))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the glue on four gloo ranks
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, os, sys
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflow_ri_tpu_torch.parallel import distributed as D
from opticalflow_ri_tpu_torch.parallel import exchange_halo, gather_axis, make_mesh
from opticalflow_ri_tpu_torch.parallel.sharded_glue import (
    check_splits, pil_resize_sharded, spline_upsample_sharded, symmetric_warp_pair_sharded)

D.initialize(init, world, rank, device="cpu")
facts, arrays = {"counts": {}}, {}
lead = rank == 0
yx = ("y", "x")
meshes = {"122": make_mesh(shape=(1, 2, 2), device_type="cpu"),
          "141": make_mesh(shape=(1, 4, 1), device_type="cpu")}

def tiles(m, spec, *xs):
    return [torch.as_tensor(x)[D.local_slices(m, tuple(x.shape), spec)].contiguous() for x in xs]

def keep(name, m, spec, t):
    g = D.gather_global(m, t, spec)
    if lead:
        arrays[name] = g.numpy()

def raised(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None

rng = np.random.default_rng(11)
big = rng.uniform(0, 255, (160, 128)).astype(np.float32)
small = rng.normal(0, 2, (80, 64)).astype(np.float32)
u, v = (rng.uniform(-6, 6, (160, 128)).astype(np.float32) for _ in range(2))
for mname, m in meshes.items():
    (tb,), (ts,) = tiles(m, yx, big), tiles(m, yx, small)
    before = (exchange_halo.exchanges, gather_axis.gathers)
    keep(f"bicubic_down_{mname}", m, yx, pil_resize_sharded(tb, (80, 64), "bicubic", m))
    keep(f"bilinear_up_{mname}", m, yx, pil_resize_sharded(ts, (160, 128), "bilinear", m))
    keep(f"spline_up_{mname}", m, yx, spline_upsample_sharded(ts, (160, 128), m))
    facts["counts"][mname] = [exchange_halo.exchanges - before[0], gather_axis.gathers - before[1]]
    # FB's use: the rows of a whole-width stripe only
    (sb,) = tiles(m, ("y", None), big)
    keep(f"bilinear_rows_{mname}", m, ("y", None),
         pil_resize_sharded(sb, (80, 128), "bilinear", m, ("y",)))
    w1, w2 = symmetric_warp_pair_sharded(*tiles(m, yx, big, big[::-1].copy(), u, v), m)
    keep(f"warp1_{mname}", m, yx, w1)
    keep(f"warp2_{mname}", m, yx, w2)
    # gather_axis along both axes: every rank holds its row / column of tiles
    for axis, dim in (("y", -2), ("x", -1)):
        g = gather_axis(tb, m, axis, dim)
        every = [None] * world
        torch.distributed.all_gather_object(every, (D.local_slices(m, big.shape, yx), g.numpy()))
        if lead:
            facts[f"gather_{axis}_{mname}"] = all(
                np.array_equal(arr, big[(slice(None), sl[1]) if axis == "y" else (sl[0], slice(None))])
                for sl, arr in every)
    # shapes that do not split, and a band past the neighbour's tile
    facts[f"odd_out_{mname}"] = raised(lambda: pil_resize_sharded(tb, (81, 64), "bicubic", m))
    facts[f"odd_spline_{mname}"] = raised(lambda: spline_upsample_sharded(ts, (161, 128), m))
    facts[f"odd_level_{mname}"] = raised(lambda: check_splits((81, 63), m, "level 1"))
    (t64,) = tiles(m, yx, np.ones((64, 64), np.float32))
    facts[f"band_{mname}"] = raised(lambda: pil_resize_sharded(t64, (4, 4), "bicubic", m))

if lead:
    for k, arr in arrays.items():
        np.save(os.path.join(out, k + ".npy"), arr)
    np.save(os.path.join(out, "in_big.npy"), big)
    np.save(os.path.join(out, "in_small.npy"), small)
    np.save(os.path.join(out, "in_u.npy"), u)
    np.save(os.path.join(out, "in_v.npy"), v)
    with open(os.path.join(out, "facts.json"), "w") as f:
        json.dump(facts, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_glue")
    out = tmp / "out"
    out.mkdir()
    spawn_ranks(_CHILD, tmp, out)
    with open(out / "facts.json") as f:
        facts = json.load(f)
    return facts, (lambda name: np.load(out / f"{name}.npy"))


def _close(got, want):
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) <= REL * np.max(np.abs(want)), np.max(np.abs(got - want))


MESHES = ["122", "141"]
RESIZES = {  # name: (input, port call, JAX call)
    "bicubic_down": ("big", lambda r, x: r.pil_resize(x, (80, 64), "bicubic")),
    "bilinear_up": ("small", lambda r, x: r.pil_resize(x, (160, 128), "bilinear")),
    "bilinear_rows": ("big", lambda r, x: r.pil_resize(x, (80, 128), "bilinear")),
    "spline_up": ("small", lambda r, x: r.spline_upsample(x, (160, 128))),
}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_on_tiles_matches_port_and_jax(ranks, name, mesh):
    """PIL bicubic down, PIL bilinear up (on (y, x) tiles and on
    whole-width stripes) and the spline upsample, on tiles, against the
    port's single-device resizes and the JAX package's, 1e-6 relative."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.ops import resize as jresize
    from opticalflow_ri_tpu_torch.ops import resize as tresize

    _, load = ranks
    src, call = RESIZES[name]
    x = load(f"in_{src}")
    got = load(f"{name}_{mesh}")
    _close(got, call(tresize, torch.from_numpy(x)).numpy())
    _close(got, np.asarray(call(jresize, jnp.asarray(x))))


@pytest.mark.parametrize("mesh", MESHES)
def test_resize_exchanges_and_gathers(ranks, mesh):
    """A PIL resize exchanges its band's apron once; the spline gathers once
    along each axis of more than one rank."""
    facts, _ = ranks
    gathers = 2 if mesh == "122" else 1
    assert facts["counts"][mesh] == [2, gathers]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_warp_equals_single_device(ranks, mesh):
    """``symmetric_warp_pair_sharded`` (an 8-cell "nearest" apron, K3's
    padded mode) against ``symmetric_warp_pair``, bit for bit."""
    from opticalflow_ri_tpu_torch.ops.warp import symmetric_warp_pair

    _, load = ranks
    big = load("in_big")
    w1, w2 = symmetric_warp_pair(*(torch.from_numpy(a) for a in (big, big[::-1].copy(),
                                                                 load("in_u"), load("in_v"))))
    np.testing.assert_array_equal(load(f"warp1_{mesh}"), w1.numpy())
    np.testing.assert_array_equal(load(f"warp2_{mesh}"), w2.numpy())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axis", ["y", "x"])
def test_gather_axis(ranks, mesh, axis):
    """Every rank ends with its column (y) or row (x) of tiles of the
    global array, in order."""
    assert ranks[0][f"gather_{axis}_{mesh}"] is True


@pytest.mark.parametrize("mesh,case,says", [
    (m, case, says) for m in MESHES for case, says in (
        ("odd_out", "(81, 64)"), ("odd_spline", "(161, 128)"), ("odd_level", "level 1"))]
    + [("141", "band", "beyond")])
def test_shapes_that_do_not_split_raise(ranks, mesh, case, says):
    """A level shape that does not split over the mesh, and a PIL band
    reaching past the neighbour's tile (64 -> 4 bicubic on 16-row tiles),
    raise ``ValueError`` naming them; on 32-row tiles the band fits."""
    msg = ranks[0][f"{case}_{mesh}"]
    assert msg is not None and says in msg, msg
    assert ranks[0]["band_122"] is None
