"""Liu-Shen fixed-point solve: the Hopper kernel and its plain version.

``liu_shen_iterate`` replaces both TPU kernels of the JAX package,
``ops/pallas/liu_shen_iter.py:liu_shen_iterate_pallas`` and
``ops/pallas/ls_tiled.py:liu_shen_iterate_pallas_tiled``, with one temporally
blocked CUDA kernel (``csrc/liu_shen.cu``) for any H, W >= 2: each launch runs
up to ``STEPS_PER_LAUNCH`` steps on a tile, and ``launch_plan`` splits a solve
into those launches.  It stops exactly as the XLA while loop does
(``models/liu_shen.py:181-196``): while err > tol and k < max_iter, err checked
after every step, with no host synchronisation inside the solve.  A stop
inside a launch is replayed from that launch's untouched source into its
destination (``stop_buffers``), so the result is the state of the step that
stopped.

``liu_shen_iterate_plain`` is the same loop in PyTorch, one ``float(err)``
host read per iteration; CPU tensors take it.  The per-iteration update
(``liu_shen_iteration`` and its two stencil helpers) lives here beside the
kernel it defines, in the association order of ``models/liu_shen.py:74-115``,
and ``models/liu_shen.py`` re-exports it.

Both return ``(u, v, err, k)``: the TPU kernels' (u, v, err) and the number
of iterations run, as 0-d tensors on the flow's device (err float32, 0 when
no iteration ran; k int32).

For a rank's tile of a sharded image (``parallel/sharded_kernel.py``) both
take ``edges``, the sides that are the image's border (``hs_iter.TOP`` ...,
``ALL`` by default): beyond a side left out the iteration reads 0 in place of
the nearest rule.  ``stop=False`` runs exactly ``max_iter`` steps and
computes no err (NaN is returned; k = max_iter): the caller takes err on the
cells it owns.  ``gate``, a 0-d int32 tensor on the flow's device, decides
on the device whether the call runs at all: 0 returns (u0, v0) with err 0
and k 0, as a solve of no step, and anything else the call without a gate.
No host reads it; the sharded solve passes each block the stop test of the
block before.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build, hs_iter
from opticalflow_ri_tpu_torch.ops.padding import pad2d

_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)

# Steps per launch (the temporal block depth T of csrc/liu_shen.cu), set by
# measurement on the H100 (PERF.md: T = 4, 6, 8, 12 and 15 measured); the
# kernel takes 1..15.
STEPS_PER_LAUNCH = 6
MAX_STEPS_PER_LAUNCH = 15
OUT, TMP, IN = 0, 1, 2  # the kernel's buffers: output pair, scratch pair, (u0, v0)
ALL = hs_iter.ALL       # every side the image's border


def launch_plan(max_iter: int, steps: int) -> tuple:
    """The launches of a solve of at most ``max_iter`` steps: (steps,
    destination) pairs, ``steps`` each and the remainder last, the
    destinations alternating between ``TMP`` and ``OUT`` so that the last
    launch writes ``OUT`` (``hs_iter.launch_plan``'s rule).  Launches after
    the stop return at once.  Empty for ``max_iter <= 0``."""
    if not 1 <= steps <= MAX_STEPS_PER_LAUNCH:
        raise ValueError(f"steps per launch must be 1..{MAX_STEPS_PER_LAUNCH}, got {steps}")
    return hs_iter.launch_plan(max_iter, steps)


def stop_buffers(plan: tuple, j: int) -> tuple:
    """(source, destination) of launch ``j`` of ``plan``: where the replay
    reads and writes when the stop falls inside that launch.  The source is
    ``IN`` for the first launch, else the previous launch's destination, which
    launch ``j`` leaves untouched."""
    return (IN if j == 0 else plan[j - 1][1]), plan[j][1]


@lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    size = lib.ofri_liu_shen_workspace_bytes
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_size_t
    entry = lib.ofri_liu_shen_iterate
    entry.argtypes = _ARGTYPES
    entry.restype = ctypes.c_int
    return size, entry


def ls_field_stencils(zp, out_h: int, out_w: int):
    """(d1, d2, f1, f2, m) for one field from a single 1-px-padded copy
    (``models/liu_shen.py:74-89``); the mixed derivative is a column
    difference of a row difference."""
    def c(dy, dx):
        return zp[..., 1 + dy : 1 + dy + out_h, 1 + dx : 1 + dx + out_w]
    d1 = (c(1, 0) - c(-1, 0)) * 0.5
    d2 = (c(0, 1) - c(0, -1)) * 0.5
    f1 = c(-1, 0) + c(1, 0)
    f2 = c(0, -1) + c(0, 1)
    rdiff = zp[..., :, 2:] - zp[..., :, :-2]
    m = (rdiff[..., 2:, :] - rdiff[..., :-2, :]) * 0.25
    return d1, d2, f1, f2, m


def ls_ring_sum(zp, out_h: int, out_w: int):
    """8-neighbour sum from a zero-padded copy in separable form
    [1,1,1]⊗[1,1,1] − δ (``models/liu_shen.py:92-98``)."""
    p = zp[..., :-2, :] + zp[..., 1:-1, :] + zp[..., 2:, :]
    q = p[..., :, :out_w] + p[..., :, 1 : out_w + 1] + p[..., :, 2 : out_w + 2]
    return q - zp[..., 1 : out_h + 1, 1 : out_w + 1]


def liu_shen_iteration(u, v, fields, h, edges: int = ALL):
    """One fixed-point update (``models/liu_shen.py:101-115``); the nearest
    rule on the sides in ``edges``, zeros beyond the others."""
    iix, iiy, ii, ixt, iyt, b11, b12, b22 = fields
    h = float(np.float32(h))
    oh, ow = u.shape[-2], u.shape[-1]

    du1, du2, fu1, _, mu = ls_field_stencils(hs_iter.pad1_edges(u, edges, "nearest"), oh, ow)
    dv1, dv2, _, fv2, mv = ls_field_stencils(hs_iter.pad1_edges(v, edges, "nearest"), oh, ow)
    ring_u = ls_ring_sum(pad2d(u, 1, "constant"), oh, ow)
    ring_v = ls_ring_sum(pad2d(v, 1, "constant"), oh, ow)
    bu = iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + h * ring_u + ixt
    bv = iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2) + h * ring_v + iyt
    u_new = -(b11 * bu + b12 * bv)
    v_new = -(b12 * bu + b22 * bv)
    return u_new, v_new


def liu_shen_iterate_plain(h, fields, u0, v0, max_iter: int = 60, tol: float = 1e-8,
                           edges: int = ALL, stop: bool = True, gate=None):
    """The XLA while loop in PyTorch: err = (‖Δu‖_F + ‖Δv‖_F)/(H·W), compared
    with tol in float32 as JAX compares them.  ``stop=False``: exactly
    ``max_iter`` steps, no err (NaN).  ``gate``: the solve's result where it
    is nonzero, else (u0, v0, 0, 0), selected with ``torch.where``."""
    if gate is not None:
        out = liu_shen_iterate_plain(h, fields, u0, v0, max_iter, tol, edges, stop)
        g = gate != 0
        return (torch.where(g, out[0], u0), torch.where(g, out[1], v0),
                torch.where(g, out[2], torch.zeros_like(out[2])),
                torch.where(g, out[3], torch.zeros_like(out[3])))
    if not stop:
        u, v, n = u0, v0, max(0, int(max_iter))
        for _ in range(n):
            u, v = liu_shen_iteration(u, v, fields, h, edges)
        err = torch.tensor(float("nan") if n else 0.0, dtype=torch.float32, device=u0.device)
        return u, v, err, torch.tensor(n, dtype=torch.int32, device=u0.device)
    tol = float(np.float32(tol))
    npix = float(u0.shape[-2] * u0.shape[-1])
    u, v = u0, v0
    err = torch.zeros((), dtype=torch.float32, device=u0.device)
    last, k = float(np.float32(1e8)), 0
    while last > tol and k < int(max_iter):
        u_new, v_new = liu_shen_iteration(u, v, fields, h, edges)
        err = (torch.linalg.norm(u_new - u) + torch.linalg.norm(v_new - v)) / npix
        last = float(err)
        u, v = u_new, v_new
        k += 1
    return u, v, err, torch.tensor(k, dtype=torch.int32, device=u0.device)


def liu_shen_iterate(h, fields, u0, v0, max_iter: int = 60, tol: float = 1e-8,
                     edges: int = ALL, stop: bool = True, gate=None):
    """Run the Liu-Shen fixed-point solve on the 8 precomputed fields
    (iix, iiy, ii, ixt, iyt, b11, b12, b22); returns (u, v, err, k).

    CPU tensors run ``liu_shen_iterate_plain``; CUDA tensors launch the
    kernel: one C call enqueues the whole solve (an init launch, the step
    launches of ``launch_plan``, which return at once after the stop, the
    replay launch and a finish launch; the init launch reads ``gate``).
    """
    if not 0 <= int(edges) <= ALL:
        raise ValueError(f"edges must be a mask of TOP, BOTTOM, LEFT, RIGHT, got {edges}")
    if gate is not None and (gate.dtype != torch.int32 or gate.dim() != 0
                             or gate.device != u0.device):
        raise ValueError(f"gate must be a 0-d int32 tensor on {u0.device}, got "
                         f"{gate.dtype} {tuple(gate.shape)} on {gate.device}")
    if fields[0].device.type == "cpu":
        return liu_shen_iterate_plain(h, fields, u0, v0, max_iter, tol, edges, stop, gate)
    build.check_fields("liu_shen_iterate", *fields, u0, v0)
    rows, cols = u0.shape
    dev = u0.device
    steps = STEPS_PER_LAUNCH
    plan = launch_plan(int(max_iter), steps)
    table = hs_iter.plan_table(plan)
    # the scratch pair and the workspace are freed on return while the
    # kernels may still run: the caching allocator hands them out again only
    # to later work on this stream, which runs after them
    u_out, v_out = (torch.empty((rows, cols), dtype=torch.float32, device=dev) for _ in range(2))
    u_tmp, v_tmp = ((torch.empty((rows, cols), dtype=torch.float32, device=dev)
                     for _ in range(2)) if len(plan) > 1 else (u_out, v_out))
    err = torch.empty((), dtype=torch.float32, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    size, entry = _entries()
    workspace = torch.empty(size(rows, cols, steps), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    liu_shen_iterate.launches += 1
    rc = entry(*(f.data_ptr() for f in fields), float(np.float32(h)), u0.data_ptr(),
               v0.data_ptr(), int(max_iter), float(np.float32(tol)), rows, cols, steps,
               ctypes.cast(table, ctypes.c_void_p), len(plan), u_out.data_ptr(),
               v_out.data_ptr(), u_tmp.data_ptr(), v_tmp.data_ptr(), err.data_ptr(),
               k.data_ptr(), workspace.data_ptr(), None if gate is None else gate.data_ptr(),
               int(edges), int(bool(stop)), dev.index or 0, stream)
    build.check(rc, "liu_shen_iterate")
    return u_out, v_out, err, k


liu_shen_iterate.launches = 0
