"""Dense-LK shift-plane build: the Hopper kernel and its plain version.

``lk_build_planes`` replaces the TPU kernel
``ops/pallas/lk_build.py:lk_build_planes_pallas`` with one CUDA kernel
(``csrc/lk_build.cu``): for each of the (2R+1)^2 integer shifts s and each
gradient g of ``g_pair``, T_g[s] = wsum(shift_s(J) * g), in ladder order.
``lk_build_planes_plain`` is the same build in PyTorch (the JAX package's
``models/lucas_kanade.py:lk_build_planes``), one batch of 2R+1 column shifts
per row shift; CPU tensors take it.

Both return (t1, t2), each ((2R+1)^2, h, w), sy-major and sx-minor.
``slab`` is the replicate-padded J image covering rows/cols
[-(hw+R), {h,w}-1 + 31-hw + R]; ``g_pair`` the (2, h+31, w+31) gradient
stack over window offsets [-hw, 31-hw] (``models/lucas_kanade.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.window_sums import (
    _smooth_factorization, base_width, wsum2d,
)

GRID = 32
EXT = GRID - 1
# the run table of csrc/lk_window.cuh: n, then per run lo, len, a, nfac, factors
MAX_RUNS = 4
MAX_FACTORS = 5
RUN_INTS = 4 + MAX_FACTORS
TABLE_INTS = 1 + MAX_RUNS * RUN_INTS


def run_table(runs) -> ctypes.Array:
    """The window's runs of ones as the LK kernels take them: each run's
    start and length, the two-level base width and the ladder factors.
    Built once per window; the table is never written."""
    return _run_table(tuple((int(lo), int(hi)) for lo, hi in runs))


@lru_cache(maxsize=None)
def _run_table(runs: tuple) -> ctypes.Array:
    if not 1 <= len(runs) <= MAX_RUNS:
        raise ValueError(f"LK kernels take 1 to {MAX_RUNS} window runs, got {runs}")
    table = [len(runs)]
    for lo, hi in runs:
        length = hi - lo + 1
        if lo < 0 or length < 1 or hi >= GRID:
            raise ValueError(f"window run {(lo, hi)} is not inside the {GRID}-sample grid")
        factors, _ = _smooth_factorization(length)
        table += [lo, length, base_width(length), len(factors)]
        table += factors + [0] * (MAX_FACTORS - len(factors))
    table += [0] * (TABLE_INTS - len(table))
    return (ctypes.c_int * TABLE_INTS)(*table)


def check_build_inputs(what: str, slab: torch.Tensor, g_pair: torch.Tensor, R: int):
    """Validate the slab and gradient pair of a CUDA build; returns (h, w)."""
    if g_pair.dim() != 3 or g_pair.shape[0] != 2:
        raise ValueError(f"{what}: g_pair must be (2, h+{EXT}, w+{EXT}), got {tuple(g_pair.shape)}")
    core_h, core_w = g_pair.shape[1], g_pair.shape[2]
    h, w = core_h - EXT, core_w - EXT
    if h < 2 or w < 2:
        raise ValueError(f"{what}: the image must be at least 2x2, got {(h, w)}")
    if g_pair.device.type != "cuda":
        raise ValueError(f"{what}: all tensors must be on one CUDA device, got {g_pair.device}")
    build.check_tensor(what, g_pair, (2, core_h, core_w), g_pair.device)
    build.check_tensor(what, slab, (core_h + 2 * R, core_w + 2 * R), g_pair.device)
    return h, w


def lk_build_planes_plain(slab, g_pair, hw: int, R: int, runs_y, runs_x,
                          hierarchical="ladder"):
    """The plane build in PyTorch, summed in the order of ``hierarchical``
    (``"ladder"`` as kernel 6; ``True``, the two-level order, for the fused
    kernel's plain version)."""
    nshift = 2 * R + 1
    _, core_h, core_w = g_pair.shape
    h, w = core_h - EXT, core_w - EXT
    t1 = torch.empty((nshift * nshift, h, w), dtype=torch.float32, device=g_pair.device)
    t2 = torch.empty_like(t1)
    for sy in range(nshift):
        rowslab = slab[sy : sy + core_h]
        # the 2R+1 column shifts of this row shift, (nshift, 1, core_h, core_w)
        js = torch.stack([rowslab[:, sx : sx + core_w] for sx in range(nshift)])[:, None]
        planes = wsum2d(js * g_pair, runs_y, runs_x, hw, h, w, hierarchical)
        t1[sy * nshift : (sy + 1) * nshift] = planes[:, 0]
        t2[sy * nshift : (sy + 1) * nshift] = planes[:, 1]
    return t1, t2


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_lk_build
    entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def lk_build_planes(slab, g_pair, hw: int, R: int, runs_y, runs_x):
    """Build the shift-plane stacks (t1, t2) in ladder order.

    CPU tensors run ``lk_build_planes_plain``; CUDA tensors launch the
    kernel, both stacks in one launch.
    """
    if g_pair.device.type == "cpu":
        return lk_build_planes_plain(slab, g_pair, hw, R, runs_y, runs_x)
    h, w = check_build_inputs("lk_build_planes", slab, g_pair, R)
    dev = g_pair.device
    nshift = 2 * R + 1
    t1 = torch.empty((nshift * nshift, h, w), dtype=torch.float32, device=dev)
    t2 = torch.empty_like(t1)
    ty, tx = run_table(runs_y), run_table(runs_x)
    entry = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lk_build_planes.launches += 1
    rc = entry(slab.data_ptr(), g_pair.data_ptr(), t1.data_ptr(), t2.data_ptr(), h, w, int(R),
               ctypes.cast(ty, ctypes.c_void_p), ctypes.cast(tx, ctypes.c_void_p),
               dev.index or 0, stream)
    build.check(rc, "lk_build_planes")
    return t1, t2


lk_build_planes.launches = 0
