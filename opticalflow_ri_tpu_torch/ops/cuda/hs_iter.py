"""Horn-Schunck Jacobi iterations: the Hopper kernel and its plain version.

``hs_iterate`` replaces both TPU kernels of the JAX package,
``ops/pallas/hs_iter.py:hs_iterate_pallas`` and
``ops/pallas/hs_tiled.py:hs_iterate_pallas_tiled``, with one CUDA kernel
(``csrc/hs_jacobi.cu``) for any H, W >= 2, on one of two paths that the
shape picks (``resident_tiles``):

* resident, where the tiles fit one wave of the card (squares up to
  ~680^2 on an H100): one launch a solve, each tile's state held on its SM
  for all the iterations, the tiles trading the bands of their cores every
  few iterations; ``resident_tiles`` sizes the tiles from (H, W, niter) and
  the SM count;
* temporally blocked elsewhere: up to ``STEPS_PER_LAUNCH`` iterations a
  launch on a 64 x 64 tile, the launches of ``launch_plan``.

``hs_iterate_plain`` is the same iteration in PyTorch, in the XLA loop's
operation order (``models/horn_schunck.py:100-112``); CPU tensors take it.

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
from typing import NamedTuple

import numpy as np
import torch

from opticalflow_ri_tpu_torch.ops.cuda import build
from opticalflow_ri_tpu_torch.ops.stencil import hs_avg3x3_padded

_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
_RESIDENT_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)

# Iterations per launch on the blocked path (the temporal block depth T of
# csrc/hs_jacobi.cu), set by measurement on the H100 (PERF.md); the kernel
# takes 1..31.
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


class ResidentTiles(NamedTuple):
    """The tiles of a resident solve (``csrc/hs_jacobi.cu``, path 2): a
    ``grid_y`` x ``grid_x`` grid of tiles, each ``core_h`` x ``core_w``
    output cells inside a ring ``ring`` cells deep, ``4 * strips`` cells
    wide and ``rows`` high (a thread a row's 4 cells), the tiles trading
    their bands every ``round`` iterations."""
    strips: int
    ring: int
    core_h: int
    grid_y: int
    grid_x: int
    round: int

    @property
    def core_w(self) -> int:
        return 4 * self.strips - 2 * self.ring

    @property
    def rows(self) -> int:
        return self.core_h + 2 * self.ring

    @property
    def tiles(self) -> int:
        return self.grid_y * self.grid_x

    def exchanges(self, niter: int) -> int:
        """The rounds that end in an exchange: none with one tile."""
        return 0 if self.tiles == 1 else max(0, -(-niter // self.round) - 1)


RESIDENT_STRIPS = (8, 16)  # the kernel's tile widths: 32 and 64 cells
MAX_THREADS = 1024         # a tile's threads, 4 cells each
# The cost model that sizes the tiles, fitted to an H100 (PERF.md, section 6): an
# iteration of a tile takes ITER_NS_PER_CELL a cell of its extended tile, and
# no less than ITER_FLOOR_NS; an exchange ROUND_NS plus ROUND_NS_PER_CELL a
# cell (the bands grow with the tile).
ITER_NS_PER_CELL = 0.23
ITER_FLOOR_NS = 150.0
ROUND_NS = 1500.0
ROUND_NS_PER_CELL = 0.7


def resident_cost_ns(tiles: ResidentTiles, niter: int) -> float:
    """The model's device time of a resident solve on ``tiles``."""
    cells = tiles.rows * 4 * tiles.strips
    return (niter * max(ITER_FLOOR_NS, cells * ITER_NS_PER_CELL)
            + tiles.exchanges(niter) * (ROUND_NS + cells * ROUND_NS_PER_CELL))


@lru_cache(maxsize=None)
def resident_tiles(h: int, w: int, niter: int, sm_count: int) -> ResidentTiles | None:
    """The tiles of the resident path for an ``h`` x ``w`` solve of
    ``niter`` iterations on a card of ``sm_count`` SMs: of every tiling
    with at most one tile an SM, each tile whole warps of at most
    ``MAX_THREADS`` threads, the one ``resident_cost_ns`` finds fastest.
    None where no tiling fits one wave: the solve takes the blocked path.
    A ring is at most a core deep where tiles meet, so that a tile's ring
    lies in its eight neighbours; one tile alone takes a ring of 1 (the
    zeros beyond the image) and runs every iteration in one round."""
    niter = max(0, int(niter))
    best, best_key = None, None
    for strips in RESIDENT_STRIPS:
        max_rows = MAX_THREADS // strips
        for ring in range(1, 2 * strips):
            core_w = 4 * strips - 2 * ring
            grid_x = -(-w // core_w)
            if grid_x > sm_count:
                continue
            seen = set()
            for grid_y in range(1, sm_count // grid_x + 1):
                core_h = -(-h // grid_y)
                core_h += -(core_h + 2 * ring) % (32 // strips)  # whole warps
                if core_h in seen:
                    continue
                seen.add(core_h)
                gy = -(-h // core_h)
                if core_h + 2 * ring > max_rows:
                    continue
                if gy * grid_x == 1:
                    if ring > 1:
                        continue
                    tiles = ResidentTiles(strips, 1, core_h, 1, 1, max(1, niter))
                else:
                    if (gy > 1 and ring > core_h) or (grid_x > 1 and ring > core_w):
                        continue
                    tiles = ResidentTiles(strips, ring, core_h, gy, grid_x, ring)
                key = (resident_cost_ns(tiles, niter), tiles.rows * strips, -tiles.tiles,
                       strips, ring, core_h)
                if best_key is None or key < best_key:
                    best, best_key = tiles, key
    return best


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@lru_cache(maxsize=None)
def plan_table(plan: tuple) -> ctypes.Array:
    """``plan`` flattened to the kernel's int table."""
    return (ctypes.c_int * max(1, 2 * len(plan)))(*(x for pair in plan for x in pair))


@lru_cache(maxsize=None)
def _entry(name: str = "ofri_hs_iterate"):
    entry = getattr(build.load_library(), name)
    entry.argtypes = _RESIDENT_ARGTYPES if name.endswith("resident") else _ARGTYPES
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
    kernel, on the resident path where ``resident_tiles`` finds tiles for
    the shape (one launch), else on the blocked path (one C call enqueues
    the launches of ``launch_plan``, ``STEPS_PER_LAUNCH`` iterations each).
    ``hs_iterate.launches`` counts the calls that launched the kernel,
    ``hs_iterate.resident`` those of them on the resident path,
    ``hs_iterate.blocked`` those on the blocked path and
    ``hs_iterate.blocked_launches`` the launches these made (75 for 600
    iterations).
    """
    if not 0 <= int(edges) <= ALL:
        raise ValueError(f"edges must be a mask of TOP, BOTTOM, LEFT, RIGHT, got {edges}")
    if fx.device.type == "cpu":
        return hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter, edges)
    build.check_fields("hs_iterate", fx, fy, ft, u0, v0)
    h, w = fx.shape
    niter = max(0, int(niter))
    tiles = resident_tiles(h, w, niter, sm_count(fx.device))
    hs_iterate.launches += 1
    if tiles is None:
        hs_iterate.blocked += 1
        return _blocked(fx, fy, ft, u0, v0, alpha, niter, edges)
    hs_iterate.resident += 1
    return _resident(fx, fy, ft, u0, v0, alpha, niter, edges, tiles)


hs_iterate.launches = 0
hs_iterate.resident = 0
hs_iterate.blocked = 0
hs_iterate.blocked_launches = 0


def _blocked(fx, fy, ft, u0, v0, alpha, niter, edges):
    steps = STEPS_PER_LAUNCH
    plan = launch_plan(niter, steps)
    hs_iterate.blocked_launches += len(plan)
    table = plan_table(plan)
    h, w = fx.shape
    u_out, v_out = (torch.empty((h, w), dtype=torch.float32, device=fx.device) for _ in range(2))
    u_tmp, v_tmp = ((torch.empty((h, w), dtype=torch.float32, device=fx.device)
                     for _ in range(2)) if len(plan) > 1 else (u_out, v_out))
    stream = torch.cuda.current_stream(fx.device).cuda_stream
    rc = _entry()(fx.data_ptr(), fy.data_ptr(), ft.data_ptr(), u0.data_ptr(), v0.data_ptr(),
                  float(np.float32(alpha)), h, w, steps, ctypes.cast(table, ctypes.c_void_p),
                  len(plan), u_out.data_ptr(), v_out.data_ptr(), u_tmp.data_ptr(),
                  v_tmp.data_ptr(), int(edges), fx.device.index or 0, stream)
    build.check(rc, "hs_iterate")
    return u_out, v_out


def _resident(fx, fy, ft, u0, v0, alpha, niter, edges, tiles: ResidentTiles):
    h, w = fx.shape
    dev = fx.device
    u_out, v_out = (torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(2))
    # the bands the tiles publish: (u, v) for each of two rounds' parities
    xchg = torch.empty((4, h, w) if tiles.tiles > 1 else (1,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _entry("ofri_hs_iterate_resident")(
        fx.data_ptr(), fy.data_ptr(), ft.data_ptr(), u0.data_ptr(), v0.data_ptr(),
        float(np.float32(alpha)), h, w, tiles.strips, tiles.ring, tiles.core_h, tiles.grid_y,
        tiles.grid_x, niter, tiles.round, u_out.data_ptr(), v_out.data_ptr(), xchg.data_ptr(),
        int(edges), dev.index or 0, stream)
    build.check(rc, "hs_iterate")
    return u_out, v_out
