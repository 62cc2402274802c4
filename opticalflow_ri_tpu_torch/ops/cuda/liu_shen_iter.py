"""Liu-Shen fixed-point solve: the Hopper kernel and its plain version.

``liu_shen_iterate`` replaces both TPU kernels of the JAX package,
``ops/pallas/liu_shen_iter.py:liu_shen_iterate_pallas`` and
``ops/pallas/ls_tiled.py:liu_shen_iterate_pallas_tiled``, with one CUDA kernel
(``csrc/liu_shen.cu``) for any H, W >= 2.  It stops exactly as the XLA while
loop does (``models/liu_shen.py:181-196``): while err > tol and k < max_iter,
err checked after every iteration, with no host synchronisation inside the
solve.

``liu_shen_iterate_plain`` is the same loop in PyTorch, one ``float(err)``
host read per iteration; CPU tensors take it.  The per-iteration update
(``liu_shen_iteration`` and its two stencil helpers) lives here beside the
kernel it defines, in the association order of ``models/liu_shen.py:74-115``,
and ``models/liu_shen.py`` re-exports it.

Both return ``(u, v, err, k)``: the TPU kernels' (u, v, err) and the number
of iterations run, as 0-d tensors on the flow's device (err float32, 0 when
no iteration ran; k int32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.padding import pad2d

_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
)


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


def liu_shen_iteration(u, v, fields, h):
    """One fixed-point update (``models/liu_shen.py:101-115``)."""
    iix, iiy, ii, ixt, iyt, b11, b12, b22 = fields
    h = float(np.float32(h))
    oh, ow = u.shape[-2], u.shape[-1]
    du1, du2, fu1, _, mu = ls_field_stencils(pad2d(u, 1, "nearest"), oh, ow)
    dv1, dv2, _, fv2, mv = ls_field_stencils(pad2d(v, 1, "nearest"), oh, ow)
    ring_u = ls_ring_sum(pad2d(u, 1, "constant"), oh, ow)
    ring_v = ls_ring_sum(pad2d(v, 1, "constant"), oh, ow)
    bu = iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + h * ring_u + ixt
    bv = iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2) + h * ring_v + iyt
    u_new = -(b11 * bu + b12 * bv)
    v_new = -(b12 * bu + b22 * bv)
    return u_new, v_new


def liu_shen_iterate_plain(h, fields, u0, v0, max_iter: int = 60, tol: float = 1e-8):
    """The XLA while loop in PyTorch: err = (‖Δu‖_F + ‖Δv‖_F)/(H·W), compared
    with tol in float32 as JAX compares them."""
    tol = float(np.float32(tol))
    npix = float(u0.shape[-2] * u0.shape[-1])
    u, v = u0, v0
    err = torch.zeros((), dtype=torch.float32, device=u0.device)
    last, k = float(np.float32(1e8)), 0
    while last > tol and k < int(max_iter):
        u_new, v_new = liu_shen_iteration(u, v, fields, h)
        err = (torch.linalg.norm(u_new - u) + torch.linalg.norm(v_new - v)) / npix
        last = float(err)
        u, v = u_new, v_new
        k += 1
    return u, v, err, torch.tensor(k, dtype=torch.int32, device=u0.device)


def liu_shen_iterate(h, fields, u0, v0, max_iter: int = 60, tol: float = 1e-8):
    """Run the Liu-Shen fixed-point solve on the 8 precomputed fields
    (iix, iiy, ii, ixt, iyt, b11, b12, b22); returns (u, v, err, k).

    CPU tensors run ``liu_shen_iterate_plain``; CUDA tensors launch the
    kernel: one C call enqueues the whole solve (an init launch, ``max_iter``
    step launches that return at once after the stop, a finish launch).
    """
    if fields[0].device.type == "cpu":
        return liu_shen_iterate_plain(h, fields, u0, v0, max_iter, tol)
    build.check_fields("liu_shen_iterate", *fields, u0, v0)
    rows, cols = u0.shape
    dev = u0.device
    # the scratch pair and the workspace are freed on return while the
    # kernels may still run: the caching allocator hands them out again only
    # to later work on this stream, which runs after them

    u_out, v_out, u_tmp, v_tmp = (torch.empty((rows, cols), dtype=torch.float32, device=dev)
                                  for _ in range(4))
    err = torch.empty((), dtype=torch.float32, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    lib = build.load_library()
    lib.ofri_liu_shen_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ofri_liu_shen_workspace_bytes.restype = ctypes.c_size_t
    workspace = torch.empty(lib.ofri_liu_shen_workspace_bytes(rows, cols), dtype=torch.uint8,
                            device=dev)
    entry = lib.ofri_liu_shen_iterate
    entry.argtypes = _ARGTYPES
    entry.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    liu_shen_iterate.launches += 1
    rc = entry(*(f.data_ptr() for f in fields), float(np.float32(h)), u0.data_ptr(),
               v0.data_ptr(), int(max_iter), float(np.float32(tol)), rows, cols,
               u_out.data_ptr(), v_out.data_ptr(), u_tmp.data_ptr(), v_tmp.data_ptr(),
               err.data_ptr(), k.data_ptr(), workspace.data_ptr(), dev.index or 0, stream)
    build.check(rc, "liu_shen_iterate")
    return u_out, v_out, err, k


liu_shen_iterate.launches = 0
