"""Dense-LK Gauss-Newton loop: the Hopper kernels and their plain versions.

``lk_gn_iterate`` replaces the TPU kernel
``ops/pallas/lk_iter.py:lk_gn_iterate_pallas`` and ``lk_fused`` replaces
``ops/pallas/lk_iter.py:lk_fused_pallas``; both kernels live in
``csrc/lk_iter.cu``.  ``lk_gn_iterate_plain`` is the GN loop in PyTorch on
whole-image tensors, and ``lk_fused_plain`` the two-level build followed by
it; CPU tensors take them.

The blend of T1/T2 at a pixel's displacement reads the 2x2 enclosing
integer shifts with tent weights max(0, 1 - |uc - s|) and adds them in the
TPU kernel's separable order (``lk_iter.py:92-106``: over sy, then over sx,
ascending, from 0), where every other tent weight is exactly 0.  The rest is
``models/lucas_kanade.py:401-435``.  Both kernels end a pixel's loop at its
first inactive step, which changes nothing for the finite fields and the
never -0 origins the LK solve makes (``csrc/lk_iter.cu``).  That is the
kernels' contract on their inputs: finite planes and fields and no -0 among
px0, py0, as ``models/lucas_kanade.py:lk_kernel_inputs`` gives them.  For
other inputs a kernel may differ from its plain version (with a NaN field
the plain loop gives NaN where the kernel keeps an inactive pixel's origin).

All return (px, py, status): the final window origins (the pixel minus the
half window plus the flow) and the 0/1 status, (h, w) float32.  ``act0`` is
the non-singular-window mask as 0/1 float32.

``lk_gn_iterate`` and its plain version take the TPU kernel's stripe
arguments ``row0``, ``img_h`` and ``img_w`` (``ops/pallas/lk_iter.py:
155-166``): the stack covers global rows [row0, row0 + h) of an
img_h x img_w image, as a rank's stripe does in the rows-sharded solve
(``parallel/sharded_kernel.py:lk_solve_sharded_kernel``).  The pixel's row
is then the global one, the out-of-bounds bail tests the image's extent,
and px, py are global window origins.  The defaults are the whole image.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.cuda.lk_build import (
    EXT, check_build_inputs, lk_build_planes_plain, run_table,
)

STEP_EPS = float(np.float32(0.01))
# the fused kernel: a cluster of blocks owns a FUSED_TILE^2 pixel tile, shift
# s in block s % size; the smallest size in FUSED_CLUSTER_SIZES whose planes
# fit shared memory
FUSED_TILE = 32
FUSED_CLUSTER_SIZES = (8, 16)
FUSED_SLOTS = 4  # planes a block builds a round: 2 shifts x 2 gradients
MAX_SMEM_BYTES = 227 * 1024


def clip_hi(R: int) -> float:
    """The upper displacement clamp R - 1e-3, rounded to float32 as JAX does."""
    return float(np.float32(int(R) - 1e-3))


def fused_plan(R: int):
    """(cluster size, shifts per block, shared bytes per block) of the fused
    kernel at shift radius R (``csrc/lk_iter.cu:fused_smem_bytes``): the
    block's planes, the tile's staged J rows ((63 + 2R)^2), both gradients
    (2 x 63^2) and the x-pass results of a round, in the smallest cluster
    that holds the planes.  Raises ValueError when none does."""
    nplanes = (2 * int(R) + 1) ** 2
    rows = FUSED_TILE + EXT
    for size in FUSED_CLUSTER_SIZES:
        per = -(-nplanes // size)
        jn = rows + 2 * int(R)
        nbytes = 4 * (per * 2 * FUSED_TILE ** 2 + jn * jn + 2 * rows * rows
                      + FUSED_SLOTS * rows * (FUSED_TILE + 1))
        if nbytes <= MAX_SMEM_BYTES:
            return size, per, nbytes
    raise ValueError(f"lk_fused: the planes of R = {R} do not fit the shared memory of a "
                     f"cluster of {FUSED_CLUSTER_SIZES[-1]} blocks")


def gn_extent(h: int, w: int, row0: int, img_h: int | None, img_w: int | None) -> tuple:
    """(row0, img_h, img_w) of a GN call on an (h, w) stack, the defaults
    filled in (the whole image); raises where the stack does not lie inside
    the image's rows."""
    img_h = h if img_h is None else int(img_h)
    img_w = w if img_w is None else int(img_w)
    row0 = int(row0)
    if row0 < 0 or row0 + h > img_h or img_w < 1:
        raise ValueError(f"lk_gn: rows [{row0}, {row0 + h}) do not lie in an image of "
                         f"{img_h} x {img_w}")
    return row0, img_h, img_w


def lk_gn_iterate_plain(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                        n_iter: int, R: int, hw: int, row0: int = 0,
                        img_h: int | None = None, img_w: int | None = None):
    """``n_iter`` Gauss-Newton steps per pixel on the plane stacks."""
    nshift = 2 * R + 1
    h, w = ia11.shape
    row0, img_h, img_w = gn_extent(h, w, row0, img_h, img_w)
    dev = ia11.device
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ii = torch.arange(row0, row0 + h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    t1f = t1.reshape(nshift * nshift, h * w)
    t2f = t2.reshape(nshift * nshift, h * w)
    lo, hi = float(-R), clip_hi(R)

    def at(tf, idx):
        return torch.gather(tf, 0, idx.reshape(1, -1)).reshape(h, w)

    px, py, active = px0, py0, act0
    status = torch.ones((h, w), dtype=torch.float32, device=dev)
    for _ in range(int(n_iter)):
        oob = ((px < -hw) | (px >= img_w) | (py < -hw) | (py >= img_h)).to(torch.float32)
        status = status * (1.0 - active * oob)
        active = active * (1.0 - oob)

        uc = (px + hw - jj).clamp(lo, hi)
        vc = (py + hw - ii).clamp(lo, hi)
        sx = torch.floor(uc)
        sy = torch.floor(vc)
        wx0 = (1.0 - (uc - sx).abs()).clamp_min(0.0)
        wx1 = (1.0 - (uc - (sx + 1.0)).abs()).clamp_min(0.0)
        wy0 = (1.0 - (vc - sy).abs()).clamp_min(0.0)
        wy1 = (1.0 - (vc - (sy + 1.0)).abs()).clamp_min(0.0)
        s00 = ((sy.long() + R) * nshift + (sx.long() + R))
        corners = (s00, s00 + nshift, s00 + 1, s00 + nshift + 1)

        sums = []
        for tf in (t1f, t2f):
            q00, q10, q01, q11 = (at(tf, c) for c in corners)
            ty0 = wy0 * q00 + wy1 * q10
            ty1 = wy0 * q01 + wy1 * q11
            sums.append(wx0 * ty0 + wx1 * ty1)
        b1 = sums[0] - c1
        b2 = sums[1] - c2

        dx = (ia12 * b2 - ia22 * b1) * 32.0
        dy = (ia12 * b1 - ia11 * b2) * 32.0
        px = px + dx * active
        py = py + dy * active
        small = ((dx.abs() < STEP_EPS) & (dy.abs() < STEP_EPS)).to(torch.float32)
        active = active * (1.0 - small)
    return px, py, status


def lk_fused_plain(slab, g_pair, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                   n_iter: int, R: int, hw: int, runs_y, runs_x):
    """The fused kernel's plain version: the two-level build, then the GN loop."""
    t1, t2 = lk_build_planes_plain(slab, g_pair, hw, R, runs_y, runs_x, hierarchical=True)
    return lk_gn_iterate_plain(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                               n_iter, R, hw)


def _outputs(like):
    return tuple(torch.empty(like.shape, dtype=torch.float32, device=like.device)
                 for _ in range(3))


@lru_cache(maxsize=None)
def _gn_entry():
    entry = build.load_library().ofri_lk_gn
    entry.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


@lru_cache(maxsize=None)
def _fused_entry():
    entry = build.load_library().ofri_lk_fused
    entry.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def lk_gn_iterate(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                  n_iter: int, R: int, hw: int, row0: int = 0,
                  img_h: int | None = None, img_w: int | None = None):
    """Run the LK Gauss-Newton loop; returns (px, py, status).

    CPU tensors run ``lk_gn_iterate_plain``; CUDA tensors launch the kernel,
    a thread a pixel, each to its first inactive step.  The inputs must keep
    the contract in the module's docstring (finite, no -0 origin); nothing
    here checks it.  ``row0``, ``img_h``, ``img_w``: the stack's place in
    the image (the module's docstring).
    """
    if ia11.device.type == "cpu":
        return lk_gn_iterate_plain(t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                                   n_iter, R, hw, row0, img_h, img_w)
    fields = (ia11, ia12, ia22, c1, c2, act0, px0, py0)
    build.check_fields("lk_gn_iterate", *fields)
    h, w = ia11.shape
    row0, img_h, img_w = gn_extent(h, w, row0, img_h, img_w)
    dev = ia11.device
    nshift = 2 * R + 1
    build.check_tensor("lk_gn_iterate", t1, (nshift * nshift, h, w), dev)
    build.check_tensor("lk_gn_iterate", t2, (nshift * nshift, h, w), dev)
    px, py, status = _outputs(ia11)
    entry = _gn_entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lk_gn_iterate.launches += 1
    rc = entry(t1.data_ptr(), t2.data_ptr(), *(f.data_ptr() for f in fields), px.data_ptr(),
               py.data_ptr(), status.data_ptr(), h, w, int(n_iter), int(R), int(hw),
               clip_hi(R), row0, img_h, img_w, dev.index or 0, stream)
    build.check(rc, "lk_gn_iterate")
    return px, py, status


lk_gn_iterate.launches = 0


def lk_fused(slab, g_pair, ia11, ia12, ia22, c1, c2, act0, px0, py0,
             n_iter: int, R: int, hw: int, runs_y, runs_x):
    """Build the planes (two-level order) and run the GN loop in one launch;
    returns (px, py, status).

    CPU tensors run ``lk_fused_plain``; CUDA tensors launch the kernel: a
    cluster of blocks per 32x32 pixel tile holds the tile's planes in its
    shared memory (``fused_plan``; R <= 7), and raises where R's planes do
    not fit or the cluster cannot be scheduled.  The inputs must keep the
    contract in the module's docstring, as for ``lk_gn_iterate``.
    """
    if ia11.device.type == "cpu":
        return lk_fused_plain(slab, g_pair, ia11, ia12, ia22, c1, c2, act0, px0, py0,
                              n_iter, R, hw, runs_y, runs_x)
    fields = (ia11, ia12, ia22, c1, c2, act0, px0, py0)
    build.check_fields("lk_fused", *fields)
    h, w = check_build_inputs("lk_fused", slab, g_pair, R)
    if (h, w) != tuple(ia11.shape) or g_pair.device != ia11.device:
        raise ValueError(f"lk_fused: fields {tuple(ia11.shape)} on {ia11.device} do not "
                         f"match the slab's image {(h, w)} on {g_pair.device}")
    cluster = fused_plan(R)[0]
    dev = ia11.device
    px, py, status = _outputs(ia11)
    ty, tx = run_table(runs_y), run_table(runs_x)
    entry = _fused_entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lk_fused.launches += 1
    rc = entry(slab.data_ptr(), g_pair.data_ptr(), *(f.data_ptr() for f in fields),
               px.data_ptr(), py.data_ptr(), status.data_ptr(), h, w, int(n_iter), int(R),
               int(hw), clip_hi(R), ctypes.cast(ty, ctypes.c_void_p),
               ctypes.cast(tx, ctypes.c_void_p), cluster, dev.index or 0, stream)
    build.check(rc, "lk_fused")
    return px, py, status


lk_fused.launches = 0
