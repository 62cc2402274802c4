"""Dense windowed Lucas-Kanade optical flow (port of ``models/lucas_kanade.py``).

The solver of the JAX package, the shift-plane decomposition: the
Gauss-Newton residual sums split into iteration-independent constants
c1, c2 = wsum(I * g) and the planes T_g[s] = wsum(shift_s(J) * g) for every
integer shift s in [-R, R]^2, so that a GN step blends 2x2 planes at the
pixel's displacement.  On CUDA tensors the planes are built by the Hopper
kernel ``ops/cuda/lk_build.py:lk_build_planes`` and the GN loop runs in
``ops/cuda/lk_iter.py:lk_gn_iterate`` (``impl="auto"``), or both in the
fused kernel ``ops/cuda/lk_iter.py:lk_fused`` (``impl="fused"``); CPU tensors
run their plain PyTorch versions.

Parity notes carried over from the JAX package (ref: the OpenCL kernel
src/pyrlkDenseLargeW.cl:304-669):
  * replicate padding of both images (the sampler's CLAMP_TO_EDGE);
  * Scharr-style gradients with weights 3/10/3;
  * 0/1 window weights over the 32-sample grid, asymmetric windows included
    (``window_mask``, a copy of ``oracle/lucas_kanade.py:33-59``);
  * singular windows (det < 1.192092896e-7) keep the input flow, status 0;
  * the per-pixel |delta| < 0.01 exit and the window-out-of-image bail as
    masks on a fixed trip count, with the x32 step scale;
  * integer shifts clamped to [-R, R - 1e-3] (R = ``max_shift`` = 5): the
    JAX package's documented divergence for flows beyond R px.

The JAX ``impl`` values ``"xla"``, ``"pallas_build"``, ``"pallas_xlabuild"``
and ``"pallas_striped"`` choose TPU VMEM layouts and raise here.

The rows-sharded solve is ``parallel/sharded_kernel.py:lk_solve_sharded_kernel``.
While ``parallel.context.kernel_sharded_solvers(mesh)`` is active the
adapter takes this rank's ("y", "x") tiles, gathers them along x into that
solve's ("y", None) stripes and keeps its own x block; the vorticity test
takes the global mean.  A stripe the solve refuses raises ``ValueError``
(no single-device fallback), and so does the error map, a single-device
opt-in whose SAD pass has no sharded form.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import lk_build, lk_iter
from opticalflow_ri_tpu_torch.ops.cuda.lk_build import lk_build_planes_plain
from opticalflow_ri_tpu_torch.ops.padding import pad2d
from opticalflow_ri_tpu_torch.ops.stencil import correlate3x3
from opticalflow_ri_tpu_torch.ops.window_sums import runs_from_mask, wsum2d
from opticalflow_ri_tpu_torch.utils.device import capturing, device_constant
from opticalflow_ri_tpu_torch.utils.timing import span

_GRID = 32
_D_EPS = 1.192092896e-07


def window_mask(win: int, asym_near: int, asym_far: int) -> np.ndarray:
    """Per-column weights over the 32-sample grid, replicating the kernel's
    tile weight rules (ref: src/pyrlkDenseLargeW.cl:321-374).  ``win`` is the
    full window size (2*halfWindow+1); near/far are the asymmetric-window
    flags (left/top, right/bottom)."""
    m = np.zeros(_GRID, np.float32)
    large = win >= 16  # the -DWSX=1 / -DWSY=1 compile path
    for c in range(_GRID):
        tile, lid = divmod(c, 8)
        if large:
            if tile == 0:
                w = 1.0
            elif tile == 1:
                w = (1.0 - asym_near) if lid == 0 else 1.0
            else:
                w = 1.0 if (c < win - asym_far) else 0.0
        else:
            if tile == 0:
                w = 1.0
            elif tile == 1:
                w = 1.0 if (c < win - asym_far) else 0.0
                if lid == 0:
                    w = 1.0 - asym_near
            else:
                w = 0.0
        m[c] = w
    return m


def lk_build_planes(slab, g_pair, runs_y, runs_x, hw, h, w, R, hierarchical=False):
    """Shift planes T[s] = wsum(shift_s(J) * g) for s in [-R, R]^2, the plain
    build of ``models/lucas_kanade.py:116-150``; returns (t1s, t2s), each
    ((2R+1)^2, h, w), sy-major and sx-minor."""
    _, core_h, core_w = g_pair.shape
    if (core_h, core_w) != (h + _GRID - 1, w + _GRID - 1):
        raise ValueError(f"g_pair {tuple(g_pair.shape)} does not cover a {(h, w)} image")
    return lk_build_planes_plain(slab, g_pair, hw, R, runs_y, runs_x, hierarchical)


def lk_solve_fields(ipad, jpad, hw: int, R: int, runs_y, runs_x, h: int, w: int):
    """Iteration-invariant LK solve fields from the padded image pair (pad
    width hw + (GRID - hw) + R + 1 on every side): the gradient stack over
    the window offsets, the J slab covering all integer shifts, the inverted
    structure tensor, the constant window sums and the non-singular mask
    (``models/lucas_kanade.py:153-207``).  All returned tensors are
    contiguous."""
    pad = lk_pad(R)

    def grads(p):
        gx = 3.0 * (p[:-2, 2:] + p[2:, 2:] - p[:-2, :-2] - p[2:, :-2]) + 10.0 * (
            p[1:-1, 2:] - p[1:-1, :-2]
        )
        gy = 3.0 * (p[2:, :-2] + p[2:, 2:] - p[:-2, :-2] - p[:-2, 2:]) + 10.0 * (
            p[2:, 1:-1] - p[:-2, 1:-1]
        )
        return gx, gy

    gxp, gyp = grads(ipad)

    core_h = h + _GRID - 1
    core_w = w + _GRID - 1
    o = pad - 1 - hw  # start of off=-hw in gradient-array coords
    gx_core = gxp[o : o + core_h, o : o + core_w]
    gy_core = gyp[o : o + core_h, o : o + core_w]
    oi = pad - hw
    i_core = ipad[oi : oi + core_h, oi : oi + core_w]

    def wsum(x):
        return wsum2d(x, runs_y, runs_x, hw, h, w, hierarchical="ladder")

    # structure tensor (weights are 0/1, so w == w^2)
    a11 = wsum(gx_core * gx_core)
    a12 = wsum(gx_core * gy_core)
    a22 = wsum(gy_core * gy_core)
    det = a11 * a22 - a12 * a12
    ok = det >= float(np.float32(_D_EPS))
    det_safe = torch.where(ok, det, torch.ones_like(det))
    ia11 = a11 / det_safe
    ia12 = a12 / det_safe
    ia22 = a22 / det_safe

    c1 = wsum(i_core * gx_core)
    c2 = wsum(i_core * gy_core)

    g_pair = torch.stack([gx_core, gy_core])
    slab = jpad[oi - R : oi - R + core_h + 2 * R, oi - R : oi - R + core_w + 2 * R].contiguous()
    fields = (ia11, ia12, ia22, c1, c2)
    return (g_pair, slab, *(f.contiguous() for f in fields), ok)


@lru_cache(maxsize=None)
def _error_weights(half_window: int, asym: tuple) -> np.ndarray:
    """The GetError weights over the 32x32 grid: the symmetric window's mask
    times the solve's (possibly asymmetric) window."""
    win = 2 * half_window + 1
    wx, wy, _, _ = _window_runs(half_window, asym)
    sym = window_mask(win, 0, 0)
    return (sym[:, None] * sym[None, :]) * (wy[:, None] * wx[None, :])


def _lk_error_map(ipad, jpad, px, py, ok, hw, asym, pad, h, w):
    """Weighted SAD error map of the final warped window, the CL kernel's
    GetError pass (``models/lucas_kanade.py:210-258``): bilinear-sample J at
    the post-iteration window positions over the 32x32 grid, quantise both
    operands as (x*16384+256)/512, accumulate weighted |diff|, divide by
    32*win*win; singular windows keep err=0.  Plain PyTorch gathers in blocks
    of 16 rows."""
    dev = ipad.device
    win = 2 * hw + 1
    emask = device_constant(_error_weights, hw, tuple(int(a) for a in asym), device=dev)
    hp, wp = jpad.shape
    rr = torch.arange(_GRID + 1, device=dev)

    def quant(p):
        return ((p * 16384.0) + 256.0) / 512.0

    ipch = quant(ipad)
    jq = quant(jpad)

    block = 16 if h % 16 == 0 else h
    rows = []
    for r0 in range(0, h, block):
        pxc = px[r0 : r0 + block]
        pyc = py[r0 : r0 + block]
        nb = pxc.shape[0]
        x0 = torch.floor(pxc).to(torch.int32)
        y0 = torch.floor(pyc).to(torch.int32)
        fx = (pxc - x0)[:, :, None, None]
        fy = (pyc - y0)[:, :, None, None]
        iy = torch.clamp(y0.long() + pad, 0, hp - (_GRID + 1))
        ix = torch.clamp(x0.long() + pad, 0, wp - (_GRID + 1))
        jwin = jq[
            iy[:, :, None, None] + rr[None, None, :, None],
            ix[:, :, None, None] + rr[None, None, None, :],
        ]
        js = (
            (1 - fy) * (1 - fx) * jwin[:, :, :-1, :-1]
            + (1 - fy) * fx * jwin[:, :, :-1, 1:]
            + fy * (1 - fx) * jwin[:, :, 1:, :-1]
            + fy * fx * jwin[:, :, 1:, 1:]
        )
        # I windows at static offsets: pch[b,j,r,c] = ipad[r0+b+pad-hw+r, j+pad-hw+c]
        ib = torch.arange(nb, device=dev)[:, None].expand(nb, w) + (r0 + pad - hw)
        jb = torch.arange(w, device=dev)[None, :].expand(nb, w) + (pad - hw)
        rr32 = rr[:_GRID]
        pch = ipch[
            ib[:, :, None, None] + rr32[None, None, :, None],
            jb[:, :, None, None] + rr32[None, None, None, :],
        ]
        rows.append(torch.einsum("hwrc,rc->hw", (js - pch).abs(), emask))
    sad = torch.cat(rows, dim=0)
    return torch.where(ok, sad / float(_GRID * win * win), torch.zeros_like(sad))


def _window_runs(half_window: int, asym):
    """The x and y window masks and their runs of ones."""
    win = 2 * half_window + 1
    wx = window_mask(win, asym[0], asym[1])
    wy = window_mask(win, asym[2], asym[3])
    return wx, wy, runs_from_mask(wx), runs_from_mask(wy)


def pixel_grid(h: int, w: int, device, row0: int = 0):
    """The columns and rows of an (h, w) field as float32, the rows global
    from ``row0`` (a rows-sharded stripe's first)."""
    jj = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    ii = torch.arange(row0, row0 + h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return jj, ii


def lk_kernel_inputs(im1, im2, u0, v0, half_window: int = 13, asym=(0, 0, 0, 0),
                     max_shift: int = 5):
    """What the LK kernels take for one solve of ``lk_dense_solve``:
    (slab, g_pair, fields, runs_y, runs_x), with fields = (ia11, ia12, ia22,
    c1, c2, act0, px0, py0) — the solve fields, the non-singular mask as 0/1
    and the initial window origins, all (h, w) float32 and contiguous."""
    pad = lk_pad(max_shift)
    return lk_kernel_inputs_padded(*(pad2d(im.to(torch.float32), pad, "nearest")
                                     for im in (im1, im2)),
                                   u0, v0, half_window, asym, max_shift)


def lk_pad(max_shift: int) -> int:
    """Rows and columns the LK solve fields need around the image on each
    side: the window offsets span [-hw, 31 - hw], the shifts [-R, R], the
    gradients 1 (hw + (32 - hw) + R + 1, the JAX package's ``_lk_halo``)."""
    return _GRID + int(max_shift) + 1


def lk_kernel_inputs_padded(ipad, jpad, u0, v0, half_window: int = 13, asym=(0, 0, 0, 0),
                            max_shift: int = 5, row0: int = 0):
    """``lk_kernel_inputs`` of the (h, w) pair that ``ipad``, ``jpad`` hold
    with ``lk_pad(max_shift)`` more rows and columns on each side (the
    replicate rule's, or a neighbour's: a rows-sharded stripe's halo, its
    first row the image's ``row0``)."""
    hw, R = int(half_window), int(max_shift)
    h, w = (n - 2 * lk_pad(R) for n in ipad.shape)
    _, _, runs_x, runs_y = _window_runs(hw, asym)
    g_pair, slab, ia11, ia12, ia22, c1, c2, ok = lk_solve_fields(
        ipad.to(torch.float32), jpad.to(torch.float32), hw, R, runs_y, runs_x, h, w)
    jj, ii = pixel_grid(h, w, ipad.device, row0)
    px0 = (jj + u0.to(torch.float32) - hw).contiguous()
    py0 = (ii + v0.to(torch.float32) - hw).contiguous()
    fields = (ia11, ia12, ia22, c1, c2, ok.to(torch.float32), px0, py0)
    return slab, g_pair, fields, runs_y, runs_x


def lk_dense_solve(im1, im2, u0, v0, half_window: int = 13, n_iter: int = 5,
                   asym=(0, 0, 0, 0), max_shift: int = 5, impl: str = "auto",
                   calc_err: bool = False):
    """Dense LK over a full image; returns (u, v, status), or
    (u, v, status, err) with ``calc_err=True`` (the reference kernel's
    GetError SAD map).

    ``impl="auto"`` builds the planes (kernel ``lk_build``) and then runs the
    GN loop (kernel ``lk_gn``); ``impl="fused"`` does both in one launch
    (kernel ``lk_fused``, the two-level window-sum order).  On CPU tensors
    each runs its plain version.  Under a profiler the solve fields are a
    span ``ofri.precompute``, the plane build ``ofri.planes`` and the GN
    loop with the flow it gives ``ofri.iterate``; the opt-in error map lies
    outside them.
    """
    if impl not in ("auto", "fused"):
        raise ValueError(
            f"impl={impl!r}: the port offers impl='auto' (build + GN kernels) and "
            f"impl='fused'; the JAX package's other values select TPU VMEM layouts")
    hw, R = int(half_window), int(max_shift)
    with span("precompute"):
        slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(im1, im2, u0, v0, hw, asym, R)
    if impl == "auto":
        with span("planes"):
            t1s, t2s = lk_build.lk_build_planes(slab, g_pair, hw, R, runs_y, runs_x)
    with span("iterate"):
        if impl == "fused":
            px, py, status = lk_iter.lk_fused(slab, g_pair, *fields, n_iter, R, hw, runs_y,
                                              runs_x)
        else:
            px, py, status = lk_iter.lk_gn_iterate(t1s, t2s, *fields, n_iter, R, hw)
        ok = fields[5] > 0
        jj, ii = pixel_grid(*ok.shape, ok.device)
        u = torch.where(ok, px + hw - jj, u0.to(torch.float32))
        v = torch.where(ok, py + hw - ii, v0.to(torch.float32))
        status = torch.where(ok, status, torch.zeros_like(status))
    if not calc_err:
        return u, v, status
    pad = lk_pad(R)
    err = _lk_error_map(pad2d(im1.to(torch.float32), pad, "nearest"),
                        pad2d(im2.to(torch.float32), pad, "nearest"), px, py, ok, hw, asym,
                        pad, *ok.shape)
    return u, v, status, err


def evaluate_vorticity_asym(u, v, enable: bool, mesh=None):
    """Vorticity-based asymmetric-window selection
    (ref: src/denseLucasKanade_PyCL.py:75-92); a host-side decision, like
    the reference's pre-launch configuration.  It reads the mean vorticity
    on the host, which waits for the device: enabled, it raises inside a
    CUDA graph capture (no registered configuration enables it).  On a
    ``mesh`` u and v are this rank's ("y", "x") tiles and the mean is the
    whole image's (1-cell "symmetric" halos, the sum all-reduced)."""
    if not enable:
        return (0, 0, 0, 0)
    if capturing():
        raise RuntimeError(
            "enableVorticityEnhancement reads the flow on the host, which a CUDA graph capture "
            "forbids: run this adapter eagerly (pipeline_fn or run_config)")
    d = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32) * 0.5
    # scipy 'reflect' == the 'symmetric' border
    kv, ku = d.T[::-1, ::-1].copy(), d[::-1, ::-1].copy()
    u, v = u.to(torch.float32), v.to(torch.float32)
    if mesh is None:
        omega = float(torch.mean(correlate3x3(v, kv, "symmetric")
                                 - correlate3x3(u, ku, "symmetric")))
    else:
        from opticalflow_ri_tpu_torch.parallel.halo import reduce_over
        from opticalflow_ri_tpu_torch.parallel.sharded import _corr3_sharded

        curl = _corr3_sharded(v, kv, "symmetric", mesh) - _corr3_sharded(u, ku, "symmetric", mesh)
        total = reduce_over(torch.stack([curl.double().sum(),
                                         torch.tensor(float(curl.numel()), dtype=torch.float64,
                                                      device=curl.device)]), mesh)
        omega = float(total[0] / total[1])
    if omega < -2e-3:
        return (0, 1, 0, 1)
    if omega > 2e-3:
        return (1, 0, 0, 1)
    return (0, 0, 0, 0)


class DenseLucasKanadeAdapter:
    """Driver adapter with the reference host API
    (ref: src/denseLucasKanade_PyCL.py:33-182)."""

    def __init__(self, Niter: int = 5, halfWindow: int = 13,
                 provideGenericPyramidalDefaults: bool = True,
                 enableVorticityEnhancement: bool = False,
                 max_shift: int = 5, computeErrorMap: bool = False):
        self.Niter = int(Niter)
        self.halfWindow = int(halfWindow)
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults
        self.enableVorticityEnhancement = enableVorticityEnhancement
        self.max_shift = int(max_shift)
        # Opt-in: the reference computes its GetError SAD map at level 0 and
        # discards it; when enabled the map is kept on .lastErrorMap.
        self.computeErrorMap = bool(computeErrorMap)
        self.lastErrorMap = None

    def compute(self, im1, im2, U, V):
        from opticalflow_ri_tpu_torch.parallel.context import current_kernel_shard

        mesh = current_kernel_shard()
        asym = evaluate_vorticity_asym(U, V, self.enableVorticityEnhancement, mesh)
        if mesh is not None:
            if self.computeErrorMap:
                raise ValueError("computeErrorMap=True on a mesh: the error map is a "
                                 "single-device opt-in (its SAD pass has no sharded form)")
            from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk

            u, v, _ = sk.on_stripes(mesh, sk.lk_solve_sharded_kernel, im1, im2, U, V,
                                    half_window=self.halfWindow, n_iter=self.Niter, asym=asym,
                                    max_shift=self.max_shift)
            return u, v, True
        out = lk_dense_solve(
            im1, im2, U, V, half_window=self.halfWindow, n_iter=self.Niter, asym=asym,
            max_shift=self.max_shift, calc_err=self.computeErrorMap,
        )
        if self.computeErrorMap:
            self.lastErrorMap = out[3]
        # the reference returns its calcErr flag as the "error" (level 0 -> True)
        return out[0], out[1], True

    def getAlgoName(self):
        return "Dense LK"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "intermediateScaling": True, "scaling": False}
