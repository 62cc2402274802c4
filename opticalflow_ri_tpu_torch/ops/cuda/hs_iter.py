"""Horn-Schunck Jacobi iterations: the Hopper kernel and its plain version.

``hs_iterate`` replaces both TPU kernels of the JAX package,
``ops/pallas/hs_iter.py:hs_iterate_pallas`` and
``ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled``, with one temporally
blocked CUDA kernel (``csrc/hs_jacobi.cu``) for any H, W >= 2: each launch
runs up to ``STEPS_PER_LAUNCH`` iterations on a tile.  ``launch_plan``
splits a solve into those launches.  ``hs_iterate_plain`` is
the same iteration in PyTorch, in the XLA loop's operation order
(``models/horn_schunck.py:100-112``); CPU tensors take it.

``edges`` says which sides of the array are the image's border (``TOP``,
``BOTTOM``, ``LEFT``, ``RIGHT``; ``ALL`` by default, the whole image).  A
side left out is an apron edge: the array is one rank's tile of a sharded
image, padded there with its neighbour's rows or columns
(``parallel/sharded_kernel.py``), and the iteration reads 0 beyond it in
place of the mirror.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.stencil import hs_avg3x3_padded

_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)

# Iterations per launch (the temporal block depth T of csrc/hs_jacobi.cu), set
# by measurement on the H100 (PERF.md, PR 5); the kernel takes 1..31.
STEPS_PER_LAUNCH = 8
MAX_STEPS_PER_LAUNCH = 31
OUT, TMP = 0, 1  # the kernel's destination buffers
TOP, BOTTOM, LEFT, RIGHT = 1, 2, 4, 8  # the bits of ``edges``: the image's border sides
ALL = TOP | BOTTOM | LEFT | RIGHT


@lru_cache(maxsize=None)
def launch_plan(niter: int, steps: int) -> tuple:
    """The launches of an ``niter``-iteration solve: (iterations, destination)
    pairs, ``steps`` iterations each and the remainder last, the destinations
    alternating between ``TMP`` and ``OUT`` so that the last launch writes
    ``OUT``.  Empty for ``niter <= 0`` (the kernel then copies the input, as
    the plain loop runs no iteration)."""
    if not 1 <= steps <= MAX_STEPS_PER_LAUNCH:
        raise ValueError(f"steps per launch must be 1..{MAX_STEPS_PER_LAUNCH}, got {steps}")
    niter = max(0, niter)
    counts = [steps] * (niter // steps) + ([niter % steps] if niter % steps else [])
    n = len(counts)
    return tuple((c, OUT if (n - 1 - k) % 2 == 0 else TMP) for k, c in enumerate(counts))


@lru_cache(maxsize=None)
def plan_table(plan: tuple) -> ctypes.Array:
    """``plan`` flattened to the kernel's int table."""
    return (ctypes.c_int * max(1, 2 * len(plan)))(*(x for pair in plan for x in pair))


@lru_cache(maxsize=None)
def _entry():
    entry = build.load_library().ofri_hs_iterate
    entry.argtypes = _ARGTYPES
    entry.restype = ctypes.c_int
    return entry


def pad1_edges(x: torch.Tensor, edges: int, mode: str) -> torch.Tensor:
    """``x`` padded by one cell on each side: by the border ``mode``
    ("mirror" or "nearest") on the sides in ``edges``, by zeros on the
    others; rows first, then columns, so the corners take the column rule
    of the padded rows."""
    src = {"mirror": (1, -2), "nearest": (0, -1)}[mode]
    h, w = x.shape[-2], x.shape[-1]

    def side(z, bit, i, dim):
        if edges & bit:
            return z.narrow(dim, i, 1)
        return torch.zeros_like(z.narrow(dim, 0, 1))

    x = torch.cat([side(x, TOP, src[0], -2), x, side(x, BOTTOM, h + src[1], -2)], dim=-2)
    return torch.cat([side(x, LEFT, src[0], -1), x, side(x, RIGHT, w + src[1], -1)], dim=-1)


def hs_avg3x3_edges(x: torch.Tensor, edges: int) -> torch.Tensor:
    """``hs_avg3x3(x, "mirror")`` with the mirror only on the sides in
    ``edges`` and zeros beyond the others, in the same operation order (with
    ``ALL``, ``pad1_edges`` is ``pad2d(x, 1, "mirror")``)."""
    return hs_avg3x3_padded(pad1_edges(x, edges, "mirror"), x.shape[-2], x.shape[-1])


def hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter: int, edges: int = ALL):
    """``niter`` Jacobi iterations with the reciprocal 1/(α²+fx²+fy²) hoisted."""
    a = np.float32(alpha)
    rdenom = 1.0 / (float(a * a) + fx * fx + fy * fy)
    u, v = u0, v0
    for _ in range(int(niter)):
        u_avg = hs_avg3x3_edges(u, edges)
        v_avg = hs_avg3x3_edges(v, edges)
        der = (fx * u_avg + fy * v_avg + ft) * rdenom
        u, v = u_avg - fx * der, v_avg - fy * der
    return u, v


def hs_iterate(fx, fy, ft, u0, v0, alpha, niter: int, edges: int = ALL):
    """Run ``niter`` HS Jacobi iterations; returns (u, v).

    Same (fx, fy, ft, u0, v0, alpha, niter) -> (u, v) contract as the TPU
    kernels.  CPU tensors run ``hs_iterate_plain``; CUDA tensors launch the
    kernel (one C call enqueues the launches of ``launch_plan``, with
    ``STEPS_PER_LAUNCH`` iterations each).
    """
    if not 0 <= int(edges) <= ALL:
        raise ValueError(f"edges must be a mask of TOP, BOTTOM, LEFT, RIGHT, got {edges}")
    if fx.device.type == "cpu":
        return hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter, edges)
    build.check_fields("hs_iterate", fx, fy, ft, u0, v0)
    steps = STEPS_PER_LAUNCH
    plan = launch_plan(int(niter), steps)
    table = plan_table(plan)
    h, w = fx.shape
    u_out, v_out = (torch.empty((h, w), dtype=torch.float32, device=fx.device) for _ in range(2))
    u_tmp, v_tmp = ((torch.empty((h, w), dtype=torch.float32, device=fx.device)
                     for _ in range(2)) if len(plan) > 1 else (u_out, v_out))
    entry = _entry()
    stream = torch.cuda.current_stream(fx.device).cuda_stream
    hs_iterate.launches += 1
    rc = entry(fx.data_ptr(), fy.data_ptr(), ft.data_ptr(), u0.data_ptr(), v0.data_ptr(),
               float(np.float32(alpha)), h, w, steps, ctypes.cast(table, ctypes.c_void_p),
               len(plan), u_out.data_ptr(), v_out.data_ptr(), u_tmp.data_ptr(), v_tmp.data_ptr(),
               int(edges), fx.device.index or 0, stream)
    build.check(rc, "hs_iterate")
    return u_out, v_out


hs_iterate.launches = 0
