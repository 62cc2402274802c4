"""The PyTorch port's Liu-Shen refiner against the JAX package on the CPU:
``correlate3x3``, the precompute, one iteration, the whole solve (against the
XLA loop and both TPU kernels run in Pallas interpret mode, at the bars of
tests/test_pallas_kernels.py), the exact stopping rule, the adapter's
component swap, and the NumPy oracle (AEE < 1e-5, the bar of
tests/test_liu_shen.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from opticalflow_ri_tpu.models import liu_shen as jls
from opticalflow_ri_tpu.ops import stencil as jstencil
from opticalflow_ri_tpu.ops.pallas.liu_shen_iter import liu_shen_iterate_pallas
from opticalflow_ri_tpu.ops.pallas.ls_tiled import liu_shen_iterate_pallas_tiled
from opticalflow_ri_tpu.oracle.liu_shen import OracleLiuShenAdapter
from opticalflow_ri_tpu.oracle.liu_shen import liu_shen_solve as oracle_solve

from opticalflow_ri_tpu_torch import LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri_tpu_torch.models import liu_shen as tls
from opticalflow_ri_tpu_torch.ops import stencil as tstencil
from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter as tk
from conftest import aee

SHAPES = [(32, 128), (47, 61), (96, 96)]
SHAPE_IDS = ["32x128", "47x61", "96x96"]


def _inputs(shape, seed):
    """Two frames in [1, 255] and a nonzero initial flow."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(1, 255, shape).astype(np.float32)
    b = rng.uniform(1, 255, shape).astype(np.float32)
    u0 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    v0 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return a, b, u0, v0


def _fields(a, b, h):
    an, bn = a / a.max(), b / b.max()
    jf = jls.liu_shen_precompute(jnp.asarray(an), jnp.asarray(bn), h)
    tf = tls.liu_shen_precompute(torch.from_numpy(an), torch.from_numpy(bn), h)
    return jf, tf


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
@pytest.mark.parametrize("kname", ["_K_D1", "_K_D2", "_K_M", "_K_D2ND", "_K_H"])
def test_correlate3x3_matches_jax(shape, mode, kname):
    k = getattr(jls, kname)
    np.testing.assert_array_equal(getattr(tls, kname), k)
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    got = tstencil.correlate3x3(torch.from_numpy(x), k, mode).numpy()
    want = np.asarray(jstencil.correlate3x3(jnp.asarray(x), k, mode))
    _close(got, want, 1e-6, 1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("h", [0.1, 5.0, 1000.0])
def test_precompute_matches_jax(shape, h):
    a, b, _, _ = _inputs(shape, 1)
    jf, tf = _fields(a, b, h)
    assert len(tf) == 8
    for t, j in zip(tf, jf):
        assert t.dtype == torch.float32 and t.is_contiguous()
        _close(t.numpy(), j, 1e-5, 0)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_iteration_matches_jax(shape):
    a, b, u0, v0 = _inputs(shape, 2)
    jf, tf = _fields(a, b, 10.0)
    ju, jv = jls.liu_shen_iteration(jnp.asarray(u0), jnp.asarray(v0), jf, 10.0)
    tu, tv = tls.liu_shen_iteration(torch.from_numpy(u0), torch.from_numpy(v0), tf, 10.0)
    _close(tu.numpy(), ju, 1e-5, 1e-7)
    _close(tv.numpy(), jv, 1e-5, 1e-7)


@pytest.mark.parametrize("shape,h", [((32, 128), 500.0), ((47, 61), 0.1), ((96, 96), 5.0)],
                         ids=SHAPE_IDS)
def test_solve_matches_xla(shape, h):
    a, b, u0, v0 = _inputs(shape, 3)
    ju, jv, je = jls.liu_shen_solve(jnp.asarray(a), jnp.asarray(b), h, jnp.asarray(u0),
                                    jnp.asarray(v0), max_iter=8, impl="xla")
    tu, tv, te = tls.liu_shen_solve(torch.from_numpy(a), torch.from_numpy(b), h,
                                    torch.from_numpy(u0), torch.from_numpy(v0), max_iter=8)
    assert te.dim() == 0 and te.dtype == torch.float32
    _close(tu.numpy(), ju, 1e-4, 1e-6)
    _close(tv.numpy(), jv, 1e-4, 1e-6)
    _close(float(te), float(je), 1e-3, 0)


def test_plain_matches_whole_state_kernel_interpret():
    """The TPU whole-state kernel (aligned 32x128, zero init, as the JAX test)."""
    a, b, _, _ = _inputs((32, 128), 4)
    jf, tf = _fields(a, b, 500.0)
    z = np.zeros((32, 128), np.float32)
    up, vp, ep = liu_shen_iterate_pallas(500.0, jf, jnp.asarray(z), jnp.asarray(z),
                                         max_iter=8, interpret=True)
    tu, tv, te, k = tk.liu_shen_iterate(500.0, tf, torch.from_numpy(z), torch.from_numpy(z), 8)
    assert int(k) == 8
    _close(tu.numpy(), up, 1e-4, 1e-6)
    _close(tv.numpy(), vp, 1e-4, 1e-6)
    _close(float(te), float(ep), 1e-3, 0)


def test_plain_matches_tiled_kernel_interpret():
    """The TPU tiled kernel at tol = 0: 20 iterations in T=8 blocks (two full
    and a tail), 16-row stripes, nonzero init."""
    a, b, u0, v0 = _inputs((96, 128), 5)
    jf, tf = _fields(a, b, 10.0)
    ut, vt, et = liu_shen_iterate_pallas_tiled(10.0, jf, jnp.asarray(u0), jnp.asarray(v0),
                                               max_iter=20, tol=0.0, t_block=8, bh=16,
                                               interpret=True)
    tu, tv, te, k = tk.liu_shen_iterate(10.0, tf, torch.from_numpy(u0), torch.from_numpy(v0),
                                        20, 0.0)
    assert int(k) == 20
    _close(tu.numpy(), ut, 1e-5, 1e-6)
    _close(tv.numpy(), vt, 1e-5, 1e-6)
    _close(float(te), float(et), 1e-3, 0)


def _stop_tol(tf, u0, v0, k):
    """A tol that stops the solve after exactly k iterations, each of the two
    errors around it at least 1% away."""
    errs = []  # errs[j]: the error of iteration j + 1
    u, v = u0, v0
    for _ in range(k):
        un, vn = tls.liu_shen_iteration(u, v, tf, 10.0)
        errs.append(float((torch.linalg.norm(un - u) + torch.linalg.norm(vn - v))
                          / float(u.numel())))
        u, v = un, vn
    tol = float(np.sqrt(errs[k - 2] * errs[k - 1]))
    assert errs[k - 1] < 0.99 * tol and min(errs[:k - 1]) > 1.01 * tol
    return tol


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_early_stop_matches_xla(shape):
    """The stopping rule is exact: the port and the XLA loop stop at the same
    k, and the result is the fixed-count solve of k iterations."""
    a, b, u0, v0 = _inputs(shape, 6)
    _, tf = _fields(a, b, 10.0)
    tu0, tv0 = torch.from_numpy(u0), torch.from_numpy(v0)
    k = 5
    tol = _stop_tol(tf, tu0, tv0, k)
    tu, tv, te, tk_ = tk.liu_shen_iterate(10.0, tf, tu0, tv0, 40, tol)
    assert int(tk_) == k and float(te) <= tol
    fu, fv, fe, _ = tk.liu_shen_iterate(10.0, tf, tu0, tv0, k, 0.0)
    assert torch.equal(tu, fu) and torch.equal(tv, fv) and float(te) == float(fe)

    ju, jv, je = jls.liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 10.0, jnp.asarray(u0),
                                    jnp.asarray(v0), max_iter=40, tol=tol, impl="xla")
    jku, jkv, _ = jls.liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 10.0, jnp.asarray(u0),
                                     jnp.asarray(v0), max_iter=k, tol=0.0, impl="xla")
    np.testing.assert_array_equal(np.asarray(ju), np.asarray(jku))  # JAX stopped at k too
    np.testing.assert_array_equal(np.asarray(jv), np.asarray(jkv))
    _close(tu.numpy(), ju, 1e-4, 1e-6)
    _close(tv.numpy(), jv, 1e-4, 1e-6)
    _close(float(te), float(je), 1e-3, 0)


@pytest.mark.parametrize("max_iter,tol", [(0, 1e-8), (10, 1e9)], ids=["max_iter0", "tol_above_1e8"])
def test_no_iteration_returns_init(max_iter, tol):
    a, b, u0, v0 = _inputs((47, 61), 7)
    tu, tv, te = tls.liu_shen_solve(torch.from_numpy(a), torch.from_numpy(b), 5.0,
                                    torch.from_numpy(u0), torch.from_numpy(v0),
                                    max_iter=max_iter, tol=tol)
    ju, jv, je = jls.liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 5.0, jnp.asarray(u0),
                                    jnp.asarray(v0), max_iter=max_iter, tol=tol, impl="xla")
    np.testing.assert_array_equal(tu.numpy(), u0)
    np.testing.assert_array_equal(tv.numpy(), v0)
    np.testing.assert_array_equal(np.asarray(ju), u0)
    assert float(te) == float(je) == 0.0 and te.dim() == 0


def test_adapter_swaps_components_like_jax():
    a, b, u0, v0 = _inputs((47, 61), 8)
    got = LiuShenOpticalFlowAlgoAdapter(5).compute(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(u0), torch.from_numpy(v0))
    want = jls.LiuShenOpticalFlowAlgoAdapter(5).compute(a, b, u0, v0)
    assert isinstance(got, list) and len(got) == 3
    _close(got[0].numpy(), want[0], 1e-4, 1e-6)
    _close(got[1].numpy(), want[1], 1e-4, 1e-6)
    _close(float(got[2]), float(want[2]), 1e-3, 0)
    # the swap: the solver's u is the adapter's V
    rv, ru, _ = tls.liu_shen_solve(torch.from_numpy(a), torch.from_numpy(b), 5.0,
                                   torch.from_numpy(v0), torch.from_numpy(u0))
    assert torch.equal(got[0], ru) and torch.equal(got[1], rv)
    ad = LiuShenOpticalFlowAlgoAdapter(0.1)
    assert ad.getAlgoName() == jls.LiuShenOpticalFlowAlgoAdapter(0.1).getAlgoName()
    assert ad.hasGenericPyramidalDefaults() is False


def test_solve_matches_oracle(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, _ = tls.liu_shen_solve(torch.from_numpy(im1), torch.from_numpy(im2), 1000.0,
                                 torch.from_numpy(z), torch.from_numpy(z))
    ou, ov, _ = oracle_solve(im1, im2, 1000.0, z, z)
    assert aee(u.numpy(), v.numpy(), ou, ov) < 1e-5


def test_adapter_matches_oracle(piv_pair_small):
    im1, im2, u_true, v_true = piv_pair_small
    u0, v0 = 0.5 * u_true.astype(np.float32), 0.5 * v_true.astype(np.float32)
    u, v, _ = LiuShenOpticalFlowAlgoAdapter(5).compute(
        torch.from_numpy(im1), torch.from_numpy(im2), torch.from_numpy(u0), torch.from_numpy(v0))
    ou, ov, _ = OracleLiuShenAdapter(5).compute(im1, im2, u0, v0)
    assert aee(u.numpy(), v.numpy(), ou, ov) < 1e-5


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b, u0, v0 = _inputs((8, 9), 9)
    _, tf = _fields(a, b, 2.0)
    before = tk.liu_shen_iterate.launches
    got = tk.liu_shen_iterate(2.0, tf, torch.from_numpy(u0), torch.from_numpy(v0), 3, 0.0)
    want = tk.liu_shen_iterate_plain(2.0, tf, torch.from_numpy(u0), torch.from_numpy(v0), 3, 0.0)
    assert tk.liu_shen_iterate.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].dtype == torch.int32 and int(got[3]) == 3


def test_non_cpu_non_cuda_tensor_raises():
    z = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.liu_shen_iterate(1.0, (z,) * 8, z, z, 1, 0.0)
