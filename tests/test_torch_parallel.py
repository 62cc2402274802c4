"""The port's multi-GPU layer (opticalflow_ri_tpu_torch/parallel/) on four
gloo ranks on the CPU, against the JAX package's sharded functions and the
port's own single-device solvers.

One group of four ranks is spawned per module (``subprocess`` children that
never import jax, rendezvous by ``file://`` in ``tmp_path``): each rank runs
every sharded entry point on its tiles, rank 0 gathers the tiles and writes
them as ``.npy``.  The tests below compare those arrays in the parent, where
the same inputs, made from numpy seeds, go through the JAX functions on the
conftest's CPU devices (meshes of 4 of them, shaped as the ranks' meshes).
The kernel paths run their kernels' plain versions here (CPU tensors).

Bars: JAX's own sharding tests (tests/test_sharding.py,
tests/test_sharded_pallas.py); the kernel paths equal the port's
single-device solvers bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

_CHILD = r"""
import json, os, sys
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflow_ri_tpu_torch.parallel import distributed as D
from opticalflow_ri_tpu_torch.parallel import (
    batch_sharded_scan, batch_sharding, batched_hs_pipeline, exchange_halo, hs_solve_sharded,
    liu_shen_solve_sharded, make_mesh)
from opticalflow_ri_tpu_torch.parallel.auto import auto_sharded_pipeline
from opticalflow_ri_tpu_torch.parallel.sharded import hs_solve_sharded_tblocked
from opticalflow_ri_tpu_torch.parallel.sharded_kernel import (
    hs_solve_sharded_kernel, liu_shen_solve_sharded_kernel)
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

D.initialize(init, world, rank, device="cpu")
D.initialize()  # a second call is a no-op
facts = {"second_initialize_noop": True, "world": torch.distributed.get_world_size(),
         "global_mesh": list(D.global_mesh(batch=2, device_type="cpu").shape)}
arrays = {}
lead = rank == 0

def mesh(shape):
    return make_mesh(shape=shape, device_type="cpu")

def keep(name, t, m, spec):
    g = D.gather_global(m, t, spec)
    if lead:
        arrays[name] = g.numpy()

def tiles(m, spec, *xs):
    out = []
    for x in xs:
        x = torch.as_tensor(x)
        out.append(x[D.local_slices(m, tuple(x.shape), spec)].contiguous())
    return out

m22 = mesh((1, 2, 2))
yx = ("y", "x")

# exchange_halo: every rank's padded tile, in rank order
x = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
for mode in ("mirror", "symmetric", "nearest", "constant"):
    for hname, halo in (("2", 2), ("asym", ((1, 2), (3, 0)))):
        p = exchange_halo(tiles(m22, yx, x)[0], halo, mode, m22)
        every = [None] * world
        torch.distributed.all_gather_object(every, p.numpy())
        if lead:
            arrays[f"halo_{mode}_{hname}"] = np.stack(every)
try:
    exchange_halo(tiles(m22, yx, x)[0], 17, "constant", m22)
    facts["wide_halo_raises"] = False
except ValueError:
    facts["wide_halo_raises"] = True

# Horn-Schunck: body, T-blocked body, kernel path (plain kernel on the CPU)
im1, im2 = particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]
z = np.zeros_like(im1)
a, b, zt = tiles(m22, yx, im1, im2, z)
u, v, e = hs_solve_sharded(m22, a, b, 21.0, 50, zt, zt)
keep("hs_body_u", u, m22, yx); keep("hs_body_v", v, m22, yx)
facts["hs_body_err"] = float(e)
u, v, e = hs_solve_sharded_tblocked(m22, a, b, 21.0, 50, zt, zt, t_block=8)
keep("hs_tblocked_u", u, m22, yx); keep("hs_tblocked_v", v, m22, yx)
facts["hs_tblocked_err"] = float(e)

rng = np.random.default_rng(3)
ka = rng.uniform(0, 255, (64, 128)).astype(np.float32)
kb = rng.uniform(0, 255, (64, 128)).astype(np.float32)
kz = np.zeros_like(ka)
t1, t2, tz = tiles(m22, yx, ka, kb, kz)
u, v, e = hs_solve_sharded_kernel(m22, t1, t2, 15.0, 25, tz, tz, t_block=8)
keep("hs_kernel_u", u, m22, yx); keep("hs_kernel_v", v, m22, yx)
facts["hs_kernel_err"] = float(e)
u2, v2, _ = hs_solve_sharded(m22, t1, t2, 15.0, 25, tz, tz, impl="kernel", t_block=8)
facts["hs_impl_kernel_same"] = bool(torch.equal(u, u2) and torch.equal(v, v2))

# the batched pipeline on a (2, 1, 2) mesh: dp over pairs x rows
m212 = mesh((2, 1, 2))
bspec = D.SPEC_BATCH
s1 = np.stack([im1, im1 * 0.5])
s2 = np.stack([im2, im2 * 0.5])
b1, b2 = D.shard_batch_global(m212, *tiles(m212, bspec, s1, s2))
u, v, e = batched_hs_pipeline(m212, b1, b2, niter=20)
keep("batched_u", u, m212, bspec); keep("batched_v", v, m212, bspec)
errs = [None] * world
torch.distributed.all_gather_object(errs, (D.local_slices(m212, s1.shape, bspec)[0].start,
                                           e.tolist()))
facts["batched_err"] = {str(s + i): x for s, es in errs for i, x in enumerate(es)}
try:
    D.shard_batch_global(m212, b1[:, :-1], global_shape=s1.shape)
    facts["shard_mismatch_raises"] = False
except ValueError:
    facts["shard_mismatch_raises"] = True

# Liu-Shen: body on (y, x) tiles, kernel path on (y, None) stripes
u, v, e = liu_shen_solve_sharded(m22, a, b, 1000.0, zt, zt)
keep("ls_body_u", u, m22, yx); keep("ls_body_v", v, m22, yx)
facts["ls_body_err"] = float(e)
m141 = mesh((1, 4, 1))
rows = ("y", None)
rng = np.random.default_rng(7)
la = rng.uniform(1, 255, (64, 128)).astype(np.float32)
lb = rng.uniform(1, 255, (64, 128)).astype(np.float32)
lz = np.zeros_like(la)
r1, r2, rz = tiles(m141, rows, la, lb, lz)
# the solve with every host read of a tensor counted
host_reads = []
def counted_read(name, f):
    def read(self, *a, **k):
        host_reads.append(name)
        return f(self, *a, **k)
    return read
saved = {n: getattr(torch.Tensor, n) for n in
         ("item", "__float__", "__int__", "__bool__", "tolist", "numpy")}
for n, f in saved.items():
    setattr(torch.Tensor, n, counted_read(n, f))
try:
    u, v, e = liu_shen_solve_sharded_kernel(m141, r1, r2, 10.0, rz, rz, max_iter=10, tol=0.0,
                                            t_block=4)
finally:
    for n, f in saved.items():
        setattr(torch.Tensor, n, f)
keep("ls_kernel_u", u, m141, rows); keep("ls_kernel_v", v, m141, rows)
facts["ls_kernel_err"] = float(e)
facts["ls_kernel_host_reads"] = host_reads
u2, v2, _ = liu_shen_solve_sharded(m141, r1, r2, 10.0, rz, rz, max_iter=10, tol=0.0,
                                   impl="kernel", t_block=4)
facts["ls_impl_kernel_same"] = bool(torch.equal(u, u2) and torch.equal(v, v2))
try:
    liu_shen_solve_sharded(m22, a, b, 10.0, zt, zt, impl="kernel")
    facts["ls_kernel_2d_mesh_raises"] = False
except ValueError:
    facts["ls_kernel_2d_mesh_raises"] = True

# auto_sharded_pipeline: route 1, and route 2 raising where it cannot run:
# a pyramid level that does not split (162 x 128: the coarse level has 81
# rows), LK stripes thinner than the 38-row apron (64 x 128 on y = 2), and
# batch=True
fn = auto_sharded_pipeline("HS_Fs3_4", m22)
u, v = fn(a, b)
keep("auto_u", u, m22, yx); keep("auto_v", v, m22, yx)
odd = torch.zeros((81, 64))
for name, batch, args in (("HS_Fs3_4_PyrLvls2", False, (odd, odd)),
                          ("LK_Fs2_0", False, (t1, t2)), ("HS_Fs3_4", True, None)):
    try:
        auto_sharded_pipeline(name, m22, batch=batch)(*args)
        facts[f"route2_{name}_{batch}"] = "ran"
    except (NotImplementedError, ValueError) as err:
        facts[f"route2_{name}_{batch}"] = [type(err).__name__, str(err)]

# the batch-sharded scan on a (4, 1, 1) mesh
m411 = mesh((4, 1, 1))
pairs = [particle_image_pair(shape=(48, 64), seed=i)[:2] for i in range(8)]
q1 = torch.as_tensor(np.stack([p[0] for p in pairs]))
q2 = torch.as_tensor(np.stack([p[1] for p in pairs]))
take = batch_sharding(m411)
us, vs = batch_sharded_scan("HS_Fs0_0", m411)(take(q1), take(q2), device="cpu")
keep("scan_u", us, m411, ("batch", None, None)); keep("scan_v", vs, m411, ("batch", None, None))
from opticalflow_ri_tpu_torch.compile import scan_pipeline
facts["scan_one_way_is_scan_pipeline"] = batch_sharded_scan("HS_Fs0_0", m22) is scan_pipeline("HS_Fs0_0")

if lead:
    for k, arr in arrays.items():
        np.save(os.path.join(out, k + ".npy"), arr)
    with open(os.path.join(out, "facts.json"), "w") as f:
        json.dump(facts, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank)
"""


def spawn_ranks(child: str, tmp, *args, timeout=240):
    """Run ``child`` as ``WORLD`` gloo ranks (``python -c``, OMP_NUM_THREADS=1,
    rendezvous in ``tmp``); fail with every rank's output if one fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), str(WORLD), init, *map(str, args)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, (
            f"rank {r}: rc={p.returncode}\nstdout={out}\nstderr={err[-4000:]}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    out = tmp / "out"
    out.mkdir()
    spawn_ranks(_CHILD, tmp, out)
    with open(out / "facts.json") as f:
        facts = json.load(f)
    return facts, (lambda name: np.load(out / f"{name}.npy"))


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape),
                ("batch", "y", "x"))


def _aee(u, v, ur, vr):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ur), np.asarray(v) - np.asarray(vr))))


def _medium():
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    return particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)[:2]


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(ROOT, "opticalflow_ri_tpu_torch")
    for d, _, files in os.walk(pkg):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    # the card machine has no JAX: its scripts and card tests run there
    for d, prefix in (("scripts", "torch_"), ("tests", "test_torch_cuda_")):
        yield from (os.path.join(ROOT, d, f) for f in os.listdir(os.path.join(ROOT, d))
                    if f.startswith(prefix) and f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _port_sources()))
def test_port_source_imports_no_jax(path):
    """No module of the port, and none of the scripts and card tests that run
    beside it on the card, imports jax or the JAX package
    (``opticalflow_ri_tpu``)."""
    import re

    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax\b|opticalflow_ri_tpu\b).*$", src, re.M)
    assert not bad, bad


def test_parallel_import_leaves_jax_out():
    code = ("import sys, opticalflow_ri_tpu_torch.parallel, "
            "opticalflow_ri_tpu_torch.parallel.auto, opticalflow_ri_tpu_torch.parallel.distributed, "
            "opticalflow_ri_tpu_torch.parallel.sharded_kernel; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# mesh, distributed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(8, 1), (8, 2), (4, 1), (1, 1), (4, 4), (6, 1), (12, 2)])
def test_mesh_shape_for_equals_jax(n, batch):
    from opticalflow_ri_tpu.parallel.mesh import mesh_shape_for as jax_shape
    from opticalflow_ri_tpu_torch.parallel.mesh import mesh_shape_for

    assert mesh_shape_for(n, batch) == jax_shape(n, batch)


def test_initialize_twice_is_a_noop(ranks):
    facts, _ = ranks
    assert facts["second_initialize_noop"] and facts["world"] == WORLD


def test_global_mesh_shape_equals_jax(ranks):
    """``global_mesh(batch=2)`` over the four ranks: JAX's factoring."""
    from opticalflow_ri_tpu.parallel.mesh import mesh_shape_for as jax_shape

    assert tuple(ranks[0]["global_mesh"]) == jax_shape(WORLD, 2)


def test_shard_batch_global_rejects_a_wrong_block(ranks):
    assert ranks[0]["shard_mismatch_raises"]


def test_initialize_without_cuda_raises():
    """Asked for the card (the default) where there is none, a rank raises
    before it joins a group."""
    from opticalflow_ri_tpu_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("file:///nonexistent", 1, 0)


# ---------------------------------------------------------------------------
# halo exchange against JAX's, four modes, two halo shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hname,halo", [("2", 2), ("asym", ((1, 2), (3, 0)))])
@pytest.mark.parametrize("mode", ["mirror", "symmetric", "nearest", "constant"])
def test_exchange_halo_equals_jax(ranks, mode, hname, halo):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from opticalflow_ri_tpu.parallel.halo import exchange_halo

    x = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
    f = shard_map(partial(exchange_halo, halo=halo, mode=mode), mesh=_jax_mesh((1, 2, 2)),
                  in_specs=P("y", "x"), out_specs=P("y", "x"), check_vma=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(x)))
    got = ranks[1](f"halo_{mode}_{hname}")
    th, tw = got.shape[1:]
    for r in range(WORLD):
        iy, ix = divmod(r, 2)
        np.testing.assert_array_equal(got[r], want[iy * th:(iy + 1) * th, ix * tw:(ix + 1) * tw])


def test_exchange_halo_wider_than_tile_raises(ranks):
    assert ranks[0]["wide_halo_raises"]


# ---------------------------------------------------------------------------
# Horn-Schunck
# ---------------------------------------------------------------------------

def _jax_hs_sharded(fn, **kw):
    import jax.numpy as jnp

    im1, im2 = _medium()
    z = jnp.zeros(im1.shape, jnp.float32)
    return fn(_jax_mesh((1, 2, 2)), jnp.asarray(im1), jnp.asarray(im2), 21.0, 50, z, z, **kw)


@pytest.mark.parametrize("which", ["body", "tblocked"])
def test_hs_sharded_equals_jax(ranks, which):
    """JAX's bars (tests/test_sharding.py:38-40, 58-60) against JAX's sharded
    solve on the same (1, 2, 2) decomposition."""
    from opticalflow_ri_tpu.parallel.sharded import hs_solve_sharded, hs_solve_sharded_tblocked

    facts, arr = ranks
    if which == "body":
        uj, vj, ej = _jax_hs_sharded(hs_solve_sharded, impl="xla")
    else:
        uj, vj, ej = _jax_hs_sharded(hs_solve_sharded_tblocked, t_block=8)
    np.testing.assert_allclose(arr(f"hs_{which}_u"), np.asarray(uj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr(f"hs_{which}_v"), np.asarray(vj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(facts[f"hs_{which}_err"], float(ej), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("which", ["body", "tblocked"])
def test_hs_sharded_equals_port_single_device(ranks, which):
    from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve

    facts, arr = ranks
    im1, im2 = _medium()
    z = torch.zeros(im1.shape)
    u, v, e = hs_solve(_t(im1), _t(im2), 21.0, 50, z, z)
    np.testing.assert_allclose(arr(f"hs_{which}_u"), u.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr(f"hs_{which}_v"), v.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(facts[f"hs_{which}_err"], float(e), rtol=1e-4, atol=1e-7)


def _kernel_case():
    rng = np.random.default_rng(3)
    return (rng.uniform(0, 255, (64, 128)).astype(np.float32),
            rng.uniform(0, 255, (64, 128)).astype(np.float32))


def test_hs_kernel_path_equals_jax_interpret(ranks):
    """tests/test_sharded_pallas.py:41-47: JAX's kernel-sharded HS (Pallas in
    interpret mode) at the same t_block, AEE < 1e-5, err to 1e-4."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded_pallas import hs_solve_sharded_kernel

    facts, arr = ranks
    a, b = _kernel_case()
    z = jnp.zeros(a.shape, jnp.float32)
    uj, vj, ej = hs_solve_sharded_kernel(_jax_mesh((1, 2, 2)), jnp.asarray(a), jnp.asarray(b),
                                         15.0, 25, z, z, t_block=8, interpret=True)
    assert _aee(arr("hs_kernel_u"), arr("hs_kernel_v"), uj, vj) < 1e-5
    np.testing.assert_allclose(facts["hs_kernel_err"], float(ej), rtol=1e-4)


def test_hs_kernel_path_equals_port_single_device_bitwise(ranks):
    from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve

    facts, arr = ranks
    a, b = _kernel_case()
    z = torch.zeros(a.shape)
    u, v, e = hs_solve(_t(a), _t(b), 15.0, 25, z, z)
    np.testing.assert_array_equal(arr("hs_kernel_u"), u.numpy())
    np.testing.assert_array_equal(arr("hs_kernel_v"), v.numpy())
    np.testing.assert_allclose(facts["hs_kernel_err"], float(e), rtol=1e-5)
    assert facts["hs_impl_kernel_same"]


# ---------------------------------------------------------------------------
# the batched pipeline
# ---------------------------------------------------------------------------

def test_batched_pipeline_equals_jax(ranks):
    """tests/test_sharding.py:84-94 on a (2, 1, 2) mesh of each."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded import batched_hs_pipeline

    facts, arr = ranks
    im1, im2 = _medium()
    s1, s2 = np.stack([im1, im1 * 0.5]), np.stack([im2, im2 * 0.5])
    uj, vj, ej = batched_hs_pipeline(_jax_mesh((2, 1, 2)), jnp.asarray(s1), jnp.asarray(s2),
                                     niter=20)
    assert arr("batched_u").shape == s1.shape
    np.testing.assert_allclose(arr("batched_u"), np.asarray(uj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr("batched_v"), np.asarray(vj), rtol=1e-5, atol=1e-5)
    for k in range(2):
        np.testing.assert_allclose(facts["batched_err"][str(k)], float(np.asarray(ej)[k]),
                                   rtol=1e-4, atol=1e-7)


def test_batched_pipeline_equals_port_single_device(ranks):
    """Per pair: the port's calibrated pre-filter then hs_solve, bit for bit
    (the taps are added in separable_correlate's order)."""
    from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve
    from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px

    facts, arr = ranks
    im1, im2 = _medium()
    for k, scale in enumerate((1.0, 0.5)):
        f1 = gaussian_filter_px(_t(im1 * scale), 3.4, 3)
        f2 = gaussian_filter_px(_t(im2 * scale), 3.4, 3)
        z = torch.zeros_like(f1)
        u, v, e = hs_solve(f1, f2, 21.0, 20, z, z)
        np.testing.assert_array_equal(arr("batched_u")[k], u.numpy())
        np.testing.assert_array_equal(arr("batched_v")[k], v.numpy())
        np.testing.assert_allclose(facts["batched_err"][str(k)], float(e), rtol=1e-5)


# ---------------------------------------------------------------------------
# Liu-Shen
# ---------------------------------------------------------------------------

def test_liu_shen_sharded_body_equals_jax(ranks):
    """tests/test_sharding.py:63-72 on a (1, 2, 2) mesh."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded import liu_shen_solve_sharded

    _, arr = ranks
    im1, im2 = _medium()
    z = jnp.zeros(im1.shape, jnp.float32)
    uj, vj, _ = liu_shen_solve_sharded(_jax_mesh((1, 2, 2)), jnp.asarray(im1), jnp.asarray(im2),
                                       1000.0, z, z, impl="xla")
    np.testing.assert_allclose(arr("ls_body_u"), np.asarray(uj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(arr("ls_body_v"), np.asarray(vj), rtol=1e-4, atol=1e-5)


def test_liu_shen_sharded_body_equals_port_single_device(ranks):
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_solve

    facts, arr = ranks
    im1, im2 = _medium()
    z = torch.zeros(im1.shape)
    u, v, e = liu_shen_solve(_t(im1), _t(im2), 1000.0, z, z)
    np.testing.assert_allclose(arr("ls_body_u"), u.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(arr("ls_body_v"), v.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(facts["ls_body_err"], float(e), rtol=1e-3)


def _ls_kernel_case():
    rng = np.random.default_rng(7)
    return (rng.uniform(1, 255, (64, 128)).astype(np.float32),
            rng.uniform(1, 255, (64, 128)).astype(np.float32))


def test_liu_shen_kernel_path_equals_jax_interpret(ranks):
    """tests/test_sharded_pallas.py:106-115: JAX's rows-sharded Liu-Shen
    kernel (Pallas in interpret mode), the same t_block 4 (10 = 2 x 4 + a
    tail of 2), tol 0."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.parallel.sharded_pallas import liu_shen_solve_sharded_kernel

    facts, arr = ranks
    a, b = _ls_kernel_case()
    z = jnp.zeros(a.shape, jnp.float32)
    uj, vj, ej = liu_shen_solve_sharded_kernel(_jax_mesh((1, 4, 1)), jnp.asarray(a),
                                               jnp.asarray(b), 10.0, z, z, max_iter=10, tol=0.0,
                                               t_block=4, interpret=True)
    np.testing.assert_allclose(arr("ls_kernel_u"), np.asarray(uj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(arr("ls_kernel_v"), np.asarray(vj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(facts["ls_kernel_err"], float(ej), rtol=1e-3)


def test_liu_shen_kernel_path_equals_port_single_device_bitwise(ranks):
    """At max_iter (tol 0: the single-device solve runs all 10 steps) the
    block-granular stop changes nothing: bit for bit, and the stop decided
    on the device: no tensor read on the host in its 3 blocks."""
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter

    facts, arr = ranks
    a, b = (_t(x) for x in _ls_kernel_case())
    z = torch.zeros(a.shape)
    fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
    u, v, e, k = liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 10, 0.0)
    assert int(k) == 10
    np.testing.assert_array_equal(arr("ls_kernel_u"), u.numpy())
    np.testing.assert_array_equal(arr("ls_kernel_v"), v.numpy())
    np.testing.assert_allclose(facts["ls_kernel_err"], float(e), rtol=1e-6)
    assert facts["ls_kernel_host_reads"] == []
    assert facts["ls_impl_kernel_same"]


def test_liu_shen_kernel_path_needs_rows_only_mesh(ranks):
    assert ranks[0]["ls_kernel_2d_mesh_raises"]


# ---------------------------------------------------------------------------
# auto_sharded_pipeline
# ---------------------------------------------------------------------------

def test_auto_route1_equals_jax(ranks):
    """tests/test_sharded_pallas.py:335-378: against JAX's sharded HS_Fs3_4
    (its kernel route forced on, Pallas in interpret mode), AEE < 1e-5."""
    import jax.numpy as jnp

    import opticalflow_ri_tpu.ops.pallas as pallas_pkg
    from opticalflow_ri_tpu.parallel import auto

    _, arr = ranks
    im1, im2 = _medium()
    orig = pallas_pkg.pallas_default_on
    pallas_pkg.pallas_default_on = lambda: True
    try:
        uj, vj = auto.auto_sharded_pipeline("HS_Fs3_4", _jax_mesh((1, 2, 2)),
                                            kernel_interpret=True)(jnp.asarray(im1),
                                                                   jnp.asarray(im2))
    finally:
        pallas_pkg.pallas_default_on = orig
    assert _aee(arr("auto_u"), arr("auto_v"), uj, vj) < 1e-5


def test_auto_route1_equals_port_run_config_bitwise(ranks):
    from opticalflow_ri_tpu_torch.configs import run_config

    _, arr = ranks
    im1, im2 = _medium()
    u, v = run_config("HS_Fs3_4", im1, im2, device="cpu")
    np.testing.assert_array_equal(arr("auto_u"), u.numpy())
    np.testing.assert_array_equal(arr("auto_v"), v.numpy())


_ROUTE2_RAISES = {("HS_Fs3_4_PyrLvls2", False): ("ValueError", "pyramid level 1 of 2"),
                  ("LK_Fs2_0", False): ("ValueError", "38 rows"),
                  ("HS_Fs3_4", True): ("NotImplementedError", "batch_sharded_scan")}


@pytest.mark.parametrize("name,batch", [("HS_Fs3_4_PyrLvls2", False), ("LK_Fs2_0", False),
                                        ("HS_Fs3_4", True)])
def test_auto_route2_raises(ranks, name, batch):
    """Route 2 raises where it cannot run, and runs nothing in its place: a
    pyramid level that does not split over the mesh, a tile the solve
    refuses (no single-device fallback), and ``batch=True`` (JAX's vmapped
    GSPMD route).  Route 2's runs: tests/test_torch_parallel_route2.py."""
    kind, says = _ROUTE2_RAISES[(name, batch)]
    got = ranks[0][f"route2_{name}_{batch}"]
    assert got != "ran" and got[0] == kind and says in got[1], got


# ---------------------------------------------------------------------------
# the batch-sharded scan
# ---------------------------------------------------------------------------

def _scan_stacks():
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    pairs = [particle_image_pair(shape=(48, 64), seed=i)[:2] for i in range(8)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_batch_sharded_scan_equals_port_scan(ranks):
    from opticalflow_ri_tpu_torch.compile import scan_pipeline

    _, arr = ranks
    s1, s2 = _scan_stacks()
    us, vs = scan_pipeline("HS_Fs0_0")(_t(s1), _t(s2), device="cpu")
    np.testing.assert_array_equal(arr("scan_u"), us.numpy())
    np.testing.assert_array_equal(arr("scan_v"), vs.numpy())


def test_batch_sharded_scan_equals_jax(ranks):
    """The JAX package's scan_pipeline on the same stack, at the pipeline bar
    of tests/test_torch_compile.py (AEE <= 5e-6 per pair)."""
    import jax.numpy as jnp

    from opticalflow_ri_tpu.compile import scan_pipeline

    _, arr = ranks
    s1, s2 = _scan_stacks()
    uj, vj = scan_pipeline("HS_Fs0_0")(jnp.asarray(s1), jnp.asarray(s2))
    for k in range(len(s1)):
        assert _aee(arr("scan_u")[k], arr("scan_v")[k], np.asarray(uj)[k], np.asarray(vj)[k]) <= 5e-6


def test_batch_sharded_scan_one_way_shortcut(ranks):
    assert ranks[0]["scan_one_way_is_scan_pipeline"]
