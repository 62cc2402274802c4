"""The sharded pipeline made ready for one CUDA graph, on four gloo ranks on
the CPU: the sharded Liu-Shen's stop on the device, the HS and Liu-Shen
aprons written in place, no host read on routes 1 and 2, and
``auto_sharded_pipeline`` against ``sharded_pipeline_fn`` and JAX.

One group of four ranks is spawned per module (``test_torch_parallel.
spawn_ranks``: children that never import jax).  Each rank runs:

  (a) ``liu_shen_solve_sharded_kernel`` on (1, 4, 1) stripes of a 64 x 128
      pair, T = 4 and 14 steps (blocks of 4, 4, 4 and a tail of 2), with
      ``tol`` set to each block's err from a first run so that the stop
      falls after the first block, a middle one, the last full block, the
      tail, never (tol 0), and before any block (tol 1e9), each under
      the guard of (c);
  (b) ``halo.refresh_apron`` against ``_pad_interior``'s apron on (1, 2, 2)
      and (1, 4, 1), and ``_hs_body_shardkernel`` / ``_ls_body_shardkernel``
      against ``_parent_hs`` / ``_parent_ls`` below, the crop-and-pad loops
      with the host-read stop that they replace;
  (c) route 1 and one route-2 configuration per solver family plus a
      LiuSE one through ``sharded_pipeline_fn`` on (1, 2, 2) tiles of a
      160 x 128 pair, with ``torch.Tensor.item``, ``__float__``,
      ``__int__``, ``__bool__``, ``tolist`` and ``numpy`` made to raise:
      a path that reads a tensor on the host could not be captured;
      The two-level ``biLinear=False`` pyramids (HS and Liu-Shen adapters,
      the tile form of ``liu_shen_warp``) run under the same guard;
  (d) ``auto_sharded_pipeline`` on the same CPU tiles (the eager function
      there), gathered to rank 0 for the comparison with JAX;
  (e) the solve of (a) with ``halo._staged`` made true, as on gloo with
      CUDA tiles, where the loop reads the stop on the host: the same
      result as the device-gated solve, and K4/K5 calls for the blocks
      before the stop only.

Bars: everything in (a)-(d) bit for bit within the port; against JAX's
``auto_sharded_pipeline`` (its default route on the conftest's CPU
devices) the route-2 tests' bars, AEE < 1e-5 and, for LK, > 99% of the
pixels within 1e-3.  The kernel paths run their kernels' plain versions
here (CPU tensors).
"""

import json

import numpy as np
import pytest
import torch

from test_torch_parallel import spawn_ranks

GUARDED = ("HS_Fs3_4", "PyHSchunck_Fs3_4_PyrLvls2", "LK_Fs2_0", "Farneback_Fs0_0",
           "LiuSE_HS_Fs3_4_PyrLvls2")
# the two-level biLinear=False pyramids, run under the guard beside the configs
LS_WARP_GUARDED = ("biLinear_False_HS", "biLinear_False_LiuShen")
STOPS = ("first", "middle", "last_full", "tail", "never", "none")
# the stops of (e) and the blocks run before each
STAGED_STOPS = {"first": 1, "middle": 2, "never": 4, "none": 0}

_CHILD = r"""
import json, os, sys
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
GUARDED, STAGED_STOPS = json.loads(sys.argv[5]), json.loads(sys.argv[6])
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflow_ri_tpu_torch import (
    HSOpticalFlowAlgoAdapter, LiuShenOpticalFlowAlgoAdapter, generic_pyramidal_optical_flow)
from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, liu_shen_iter
from opticalflow_ri_tpu_torch.parallel import distributed as D
from opticalflow_ri_tpu_torch.parallel import halo
from opticalflow_ri_tpu_torch.parallel import (
    auto_sharded_pipeline, kernel_sharded_solvers, make_mesh, sharded_pipeline_fn)
from opticalflow_ri_tpu_torch.parallel import sharded as _sh
from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk
from opticalflow_ri_tpu_torch.parallel.halo import reduce_over, refresh_apron
from opticalflow_ri_tpu_torch.parallel.mesh import axis_size
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

D.initialize(init, world, rank, device="cpu")
facts, arrays = {}, {}
lead = rank == 0
yx, rows = ("y", "x"), ("y", None)
m22 = make_mesh(shape=(1, 2, 2), device_type="cpu")
m41 = make_mesh(shape=(1, 4, 1), device_type="cpu")

def tiles(m, spec, *xs):
    return [torch.as_tensor(x)[D.local_slices(m, tuple(x.shape), spec)].contiguous() for x in xs]

def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))

def every(value):
    got = [None] * world
    torch.distributed.all_gather_object(got, value)
    return got

# the parent's loops: a T-deep pad of u and v before every launch, a crop
# after it, and Liu-Shen's stop read on the host once a block
def _parent_hs(im1, im2, u0, v0, mesh, *, alpha, niter, t_block):
    fx, fy, ft = _sh._hs_derivatives_local(im1, im2, mesh)
    t = t_block
    h, w = im1.shape[-2], im1.shape[-1]
    edges, apron = sk._border_sides(mesh)
    fxp, fyp, ftp = (sk._pad_interior(z, t, mesh, apron) for z in (fx, fy, ft))
    u, v, done = u0, v0, 0
    while done < niter:
        k = min(t, niter - done)
        up, vp = hs_iter.hs_iterate(fxp, fyp, ftp, sk._pad_interior(u, t, mesh, apron),
                                    sk._pad_interior(v, t, mesh, apron), alpha, k, edges)
        u, v = sk._crop(up, h, w, t, apron), sk._crop(vp, h, w, t, apron)
        done += k
    return u.contiguous(), v.contiguous(), _sh._flow_err(u, v, u0, v0, mesh)

def _parent_ls(im1, im2, u0, v0, mesh, *, h_reg, max_iter, tol, t_block):
    corr = lambda z, k, mode: sk._corr3_sharded_y(z, k, mode, mesh)
    fields = _sh._ls_fields_local(im1, im2, h_reg, corr, mesh, ("y",))
    t = t_block
    h_loc, w = im1.shape[-2], im1.shape[-1]
    edges, apron = sk._border_sides(mesh, ("y",))
    pad = lambda z: sk._pad_interior(z, t, mesh, apron, ("y",))
    fields_p = tuple(pad(f) for f in fields)
    npix = float(h_loc * axis_size(mesh, "y") * w)
    def block(u, v, k):
        up, vp = pad(u), pad(v)
        if k > 1:
            up, vp = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, k - 1, 0.0,
                                                    edges, stop=False)[:2]
        un, vn = liu_shen_iter.liu_shen_iterate(h_reg, fields_p, up, vp, 1, 0.0, edges,
                                                stop=False)[:2]
        before = [sk._crop(z, h_loc, w, t, apron) for z in (up, vp)]
        after = [sk._crop(z, h_loc, w, t, apron) for z in (un, vn)]
        sums = torch.stack([((a - b).double() ** 2).sum() for a, b in zip(after, before)])
        sums = reduce_over(sums, mesh, ("y",))
        err = ((torch.sqrt(sums[0]) + torch.sqrt(sums[1])) / npix).to(torch.float32)
        return after[0].contiguous(), after[1].contiguous(), err
    tol32 = float(np.float32(tol))
    u, v = u0, v0
    err = torch.zeros((), dtype=torch.float32)
    last = float(np.float32(1e8))
    n_full, rem = divmod(int(max_iter), t)
    for n in [t] * n_full + ([rem] if rem else []):
        if not last > tol32:
            break
        u, v, err = block(u, v, n)
        last = float(err)
    return u, v, err

# every host read of a tensor made to raise: a path that reads a tensor on
# the host could not be captured
class HostRead(RuntimeError):
    pass

def refuse(name):
    def f(self, *a, **k):
        raise HostRead(f"torch.Tensor.{name} read a tensor on the host")
    return f

saved = {n: getattr(torch.Tensor, n) for n in
         ("item", "__float__", "__int__", "__bool__", "tolist", "numpy")}

def guarded(call):
    for n in saved:
        setattr(torch.Tensor, n, refuse(n))
    try:
        return call(), None
    except HostRead as err:
        return None, str(err)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)

# (a) the sharded Liu-Shen's stop on the device, at every stop position
rng = np.random.default_rng(7)
la = rng.uniform(1, 255, (64, 128)).astype(np.float32)
lb = rng.uniform(1, 255, (64, 128)).astype(np.float32)
r1, r2, rz = tiles(m41, rows, la, lb, np.zeros_like(la))
T, STEPS = 4, 14
ends = [4, 8, 12, 14]   # the steps run through each block
solve = lambda n, tol: sk.liu_shen_solve_sharded_kernel(m41, r1, r2, 10.0, rz, rz, max_iter=n,
                                                       tol=tol, t_block=T)
truncated = {n: solve(n, 0.0) for n in ends}
block_errs = [float(truncated[n][2]) for n in ends]
facts["block_errs"] = block_errs
stops = {"first": (block_errs[0], 4), "middle": (block_errs[1], 8),
         "last_full": (block_errs[2], 12), "tail": (block_errs[3], 14), "never": (0.0, 14),
         "none": (1e9, 0)}
facts["stops"], facts["stop_host_reads"] = {}, {}
for where, (tol, ran) in stops.items():
    got, facts["stop_host_reads"][where] = guarded(lambda: solve(STEPS, tol))
    got = got if got is not None else solve(STEPS, tol)
    want = truncated[ran] if ran else (rz, rz, torch.zeros((), dtype=torch.float32))
    parent = _parent_ls(r1, r2, rz, rz, m41, h_reg=10.0, max_iter=STEPS, tol=tol, t_block=T)
    facts["stops"][where] = every({
        "truncated_uv": same(got[:2], want[:2]),
        "truncated_err": bool(torch.equal(got[2], want[2])),
        "parent": same(got, parent), "err": float(got[2])})

# (b) the apron written in place against _pad_interior's
x = np.random.default_rng(1).normal(size=(40, 48)).astype(np.float32)
facts["apron"] = {}
for mname, m, spec in (("122", m22, yx), ("141", m41, yx)):
    z = tiles(m, spec, x)[0]
    for axes in (("y", "x"), ("y",)):
        _, apron = sk._border_sides(m, axes)
        want = sk._pad_interior(z, 3, m, apron, axes)
        # the owned cells as they are, the apron stale
        r0, c0 = (3 if apron[0] else 0), (3 if apron[2] and "x" in axes else 0)
        owned = (slice(r0, r0 + z.shape[0]), slice(c0, c0 + z.shape[1]))
        got = torch.full_like(want, float("nan"))
        got[owned] = want[owned]
        refresh_apron(got, 3, m, apron, axes)
        facts["apron"][f"{mname}_{'_'.join(axes)}"] = every(bool(torch.equal(got, want)))

im1, im2 = particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]
z = np.zeros_like(im1)
facts["hs_body"], facts["ls_body"] = {}, {}
for mname, m in (("122", m22), ("141", m41)):
    a, b, zt = tiles(m, yx, im1, im2, z)
    for niter, t in ((25, 8), (16, 8), (5, 8)):
        kw = dict(alpha=21.0, niter=niter, t_block=t)
        facts["hs_body"][f"{mname}_{niter}"] = every(same(
            sk._hs_body_shardkernel(a, b, zt, zt, m, **kw), _parent_hs(a, b, zt, zt, m, **kw)))
    s1, s2, sz = tiles(m, rows, im1, im2, z)
    for tol in (0.0, 1e-4, 1e9):
        kw = dict(h_reg=10.0, max_iter=18, tol=tol, t_block=8)
        facts["ls_body"][f"{mname}_{tol}"] = every(same(
            sk._ls_body_shardkernel(s1, s2, sz, sz, m, **kw),
            _parent_ls(s1, s2, sz, sz, m, **kw)))

# (c) routes 1 and 2 under the guard
a, b = tiles(m22, yx, im1, im2)
facts["guarded"] = {}
# the guard catches the parent's Liu-Shen loop, which read err on the host
facts["guard_control"] = guarded(lambda: _parent_ls(r1, r2, rz, rz, m41, h_reg=10.0,
                                                    max_iter=STEPS, tol=0.0, t_block=T))[1]
def ls_warp_pyramid(adapter, sigma):
    def run(a, b):
        with kernel_sharded_solvers(m22):
            return generic_pyramidal_optical_flow(a, b, sigma, adapter(), pyramidalLevels=2,
                                                  biLinear=False)
    return run
for name, adapter, sigma in (
        ("biLinear_False_HS", lambda: HSOpticalFlowAlgoAdapter([21.0, 45.0], 100, False), 3.4),
        ("biLinear_False_LiuShen", lambda: LiuShenOpticalFlowAlgoAdapter(0.1), 0.0)):
    facts["guarded"][name] = guarded(lambda: ls_warp_pyramid(adapter, sigma)(a, b))[1]
for name in GUARDED:
    fn = sharded_pipeline_fn(name, m22)
    flow, facts["guarded"][name] = guarded(lambda: fn(a, b))
    u, v = flow if flow is not None else fn(a, b)
    # (d) the graph-replaying entry on CPU tiles: the eager function
    got = auto_sharded_pipeline(name, m22)(a, b)
    facts.setdefault("auto_same", {})[name] = every(same(got, (u, v)))
    for k, t in enumerate(got):
        g = D.gather_global(m22, t, yx)
        if lead:
            arrays[f"{name}_{k}"] = g.numpy()

# (e) gloo with CUDA tiles stages err through host memory, and there the
# loop reads the stop: the staging predicate made true on these CPU ranks,
# against the same solve stopped on the device; K4/K5 calls counted
ls_calls = [0]
ls_kernel = liu_shen_iter.liu_shen_iterate
def ls_counted(*args, **kw):
    ls_calls[0] += 1
    return ls_kernel(*args, **kw)
liu_shen_iter.liu_shen_iterate = ls_counted
facts["staged_stop"] = {}
for where in STAGED_STOPS:
    tol = stops[where][0]
    ls_calls[0] = 0
    gated = solve(STEPS, tol)
    gated_calls = ls_calls[0]
    staged = halo._staged
    halo._staged = lambda group, t: True
    try:
        ls_calls[0] = 0
        got = solve(STEPS, tol)
    finally:
        halo._staged = staged
    facts["staged_stop"][where] = every({"same": same(got, gated), "calls": ls_calls[0],
                                         "gated_calls": gated_calls})
liu_shen_iter.liu_shen_iterate = ls_kernel

if lead:
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
    tmp = tmp_path_factory.mktemp("parallel_graph")
    out = tmp / "out"
    out.mkdir()
    spawn_ranks(_CHILD, tmp, out, json.dumps(GUARDED), json.dumps(STAGED_STOPS), timeout=300)
    with open(out / "facts.json") as f:
        facts = json.load(f)
    return facts, (lambda name: np.load(out / f"{name}.npy"))


# ---------------------------------------------------------------------------
# (a) the sharded Liu-Shen's stop on the device
# ---------------------------------------------------------------------------

def test_block_errs_fall(ranks):
    """The stop positions below need each block's err below the one
    before: a tol equal to block j's err then stops after block j."""
    errs = ranks[0]["block_errs"]
    assert all(b < a for a, b in zip(errs, errs[1:])), errs


@pytest.mark.parametrize("where", STOPS)
def test_stop_on_device_equals_truncated_solve(ranks, where):
    """At every stop position the solve equals the same solve with tol 0
    and max_iter the steps of the blocks it ran, bit for bit in u, v and
    err on every rank (no block: u0, v0 and err 0), and the parent's
    host-stopped solve."""
    for rec in ranks[0]["stops"][where]:
        assert rec["truncated_uv"] and rec["truncated_err"] and rec["parent"], rec


def test_stop_reads_nothing_on_the_host(ranks):
    """At every stop position the solve completes under the guard of (c),
    which does catch a host read: the parent's loop raised under it."""
    assert "__float__" in ranks[0]["guard_control"], ranks[0]["guard_control"]
    assert all(r is None for r in ranks[0]["stop_host_reads"].values()), \
        ranks[0]["stop_host_reads"]


# ---------------------------------------------------------------------------
# (b) the apron written in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["122_y_x", "122_y", "141_y_x", "141_y"])
def test_refresh_apron_equals_pad_interior(ranks, case):
    """The neighbours' slabs written into a stale apron give
    ``_pad_interior``'s padded tile, bit for bit on every rank."""
    assert all(ranks[0]["apron"][case])


@pytest.mark.parametrize("case", ["122_25", "122_16", "122_5", "141_25", "141_16", "141_5"])
def test_hs_body_equals_parent_loop(ranks, case):
    """u, v and err of the HS body with the apron written in place equal
    the parent's pad-and-crop loop, bit for bit (25 and 16 iterations at
    T = 8: a remainder launch and none; 5: one launch)."""
    assert all(ranks[0]["hs_body"][case])


@pytest.mark.parametrize("case", ["122_0.0", "122_0.0001", "122_1000000000.0", "141_0.0",
                                  "141_0.0001", "141_1000000000.0"])
def test_ls_body_equals_parent_loop(ranks, case):
    """The Liu-Shen body (18 steps at T = 8: two blocks and a tail) equals
    the parent's loop with the host-read stop at tol 0, 1e-4 and 1e9."""
    assert all(ranks[0]["ls_body"][case])


# ---------------------------------------------------------------------------
# (c) no host read on routes 1 and 2; (d) auto_sharded_pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GUARDED + LS_WARP_GUARDED)
def test_sharded_pipeline_reads_nothing_on_the_host(ranks, name):
    """The run completes under the guard, which does catch a host read:
    the parent's Liu-Shen loop raised under it."""
    assert "__float__" in ranks[0]["guard_control"], ranks[0]["guard_control"]
    assert ranks[0]["guarded"][name] is None, ranks[0]["guarded"][name]


@pytest.mark.parametrize("name", GUARDED)
def test_auto_on_cpu_tiles_equals_sharded_pipeline_fn(ranks, name):
    assert all(ranks[0]["auto_same"][name])


@pytest.mark.parametrize("name", GUARDED)
def test_auto_matches_jax_auto_sharded_pipeline(ranks, name):
    """Against JAX's ``auto_sharded_pipeline`` on a (1, 2, 2) mesh of the
    conftest's CPU devices, at the route-2 tests' bars."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from opticalflow_ri_tpu.parallel import auto
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    _, load = ranks
    u, v = load(f"{name}_0"), load(f"{name}_1")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("batch", "y", "x"))
    im1, im2 = particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]
    uj, vj = (np.asarray(t) for t in auto.auto_sharded_pipeline(name, mesh)(
        jnp.asarray(im1), jnp.asarray(im2)))
    if "LK" in name:
        bulk = float(((np.abs(u - uj) < 1e-3) & (np.abs(v - vj) < 1e-3)).mean())
        assert bulk > 0.99, bulk
    else:
        assert float(np.mean(np.hypot(u - uj, v - vj))) < 1e-5


# ---------------------------------------------------------------------------
# (e) the stop read on the host where gloo stages CUDA tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", list(STAGED_STOPS))
def test_staged_stop_enqueues_no_block_after_it(ranks, where):
    """With the staging predicate true, a solve stopped after block 1 (or
    2, never, or before any) makes the K4/K5 calls of the blocks before
    the stop only, two a block, where the device-gated solve makes those of
    all four; u, v and err equal the device-gated solve's bit for bit on
    every rank."""
    for rec in ranks[0]["staged_stop"][where]:
        assert rec["same"], rec
        assert rec["calls"] == 2 * STAGED_STOPS[where] and rec["gated_calls"] == 8, rec


# ---------------------------------------------------------------------------
# K4/K5's gate, plain version (the kernel's is in test_torch_cuda_parallel.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stop", [True, False], ids=["stop", "no_stop"])
@pytest.mark.parametrize("edges", [15, 0], ids=["whole", "apron"])
def test_liu_shen_plain_gate(stop, edges):
    """Gate 0 gives (u0, v0) with err 0 and k 0; gate 1 gives the call
    without a gate, bit for bit (err NaN without the stop)."""
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter

    rng = np.random.default_rng(5)
    a, b = (torch.as_tensor(rng.uniform(1, 255, (24, 40)).astype(np.float32)) for _ in range(2))
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    u0, v0 = (torch.as_tensor(rng.normal(size=(24, 40)).astype(np.float32)) for _ in range(2))
    args = (10.0, fields, u0, v0, 9, 1e-12, edges, stop)
    want = liu_shen_iter.liu_shen_iterate(*args)
    opened = liu_shen_iter.liu_shen_iterate(*args, gate=torch.ones((), dtype=torch.int32))
    shut = liu_shen_iter.liu_shen_iterate(*args, gate=torch.zeros((), dtype=torch.int32))
    assert all(torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
               for g, w in zip(opened, want))
    assert torch.isnan(opened[2]) == torch.isnan(want[2])
    assert torch.equal(shut[0], u0) and torch.equal(shut[1], v0)
    assert float(shut[2]) == 0.0 and int(shut[3]) == 0
    assert shut[3].dtype == torch.int32 and shut[2].dtype == torch.float32


def test_liu_shen_gate_must_be_a_device_int():
    from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter

    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="0-d int32"):
        liu_shen_iter.liu_shen_iterate(1.0, (z,) * 8, z, z, 2, gate=torch.ones(()))
