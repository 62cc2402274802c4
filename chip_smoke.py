#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opticalflow_ri_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's Horn-Schunck pyramidal main path, its Liu-Shen path, its
dense Lucas-Kanade path and its Farneback path on the card, in phases:

  1. device  — requires CUDA (no CPU fallback); prints the card's name and
               power limit, torch, CUDA and nvcc versions;
  2. build   — builds every kernel from csrc/ with nvcc, one process per
               source;
  3. parity  — each kernel against its plain PyTorch version on the same
               CUDA tensors (HS Jacobi at 2x2, 3x517, 333x517, 512^2 and
               2048^2, bit for bit, at 0, 1, T-1, T, T+1, 100 and 600
               iterations, T its iterations per launch; the pair
               warp at 512^2 and 333x517 on calibrated and wild flows; the
               Liu-Shen solve at 2x2, 3x517, 47x61, 333x517, 512^2 and
               2048^2, bit for bit with k equal, at 0, 1, T, T+1 and 60
               steps and for stops at k = 0, 1 and T-1 mod T, T its steps
               per launch, and with the device gate (0 and 1, with and
               without the stop, the whole image and an apron mask)
               against its plain version; the LK build at 512^2, 333x517 and
               2048^2, bit for bit, with the symmetric and an asymmetric
               window, and a four-run window at 512^2; the GN loop at those
               shapes bit for bit on a calibrated and a wild flow, the
               configs' own input (captured in run_config("LK_Fs2_0")) and
               one whose pixels stop at every step from 0 to 5 (singular
               windows, bails), at 0, 1 and 5 steps; the fused LK build+GN
               bit for bit at 47x61, 333x517,
               512^2 and 2048^2 with the three windows, and at R = 6 (a
               cluster of 16) at 512^2; the Farneback
               updateMatrices at 512^2, 333x517 and 2048^2 on calibrated
               and wild flows, and the exact gather at 512^2; the Farneback
               window blur + solve bit for bit at the Liu-Shen shapes, 1, 3,
               33 and 129 taps, both window modes and a post-scale; the
               fused Farneback loop bit for bit at those shapes, 0, 1, 2 and
               5 rounds, 1, 3, 33 and 129 taps, both modes, a post-scale and
               the exact gather);
  4. main    — the five HS configurations, the README's wrapper call, the
               four Liu-Shen configurations, the five dense-LK ones, the
               fused LK solve (``lk_dense_solve(impl="fused")``), the five
               Farneback ones and the fused Farneback loop (``fb_fused`` on
               the level-0 expansions, bit for bit ``farneback_solve``) on
               a 512^2 synthetic pair, launch counters reset just before,
               each Liu-Shen call's k printed;
               flows held against the port's plain path on the CPU (AEE <=
               5e-6) and the 96^2 golden flows of HS, HS + Liu-Shen (AEE <
               1e-3), LK (the bulk check of tests/test_golden.py) and
               Farneback (AEE < 2e-3);
  5. times   — CUDA-event medians, kernel path against plain PyTorch on the
               card, per configuration and per kernel at 512^2 and 2048^2;
               the device time per call (a CUDA graph replayed back to
               back; at 2048^2 for the HS, Liu-Shen, LK, FB blur and fused
               FB kernels) beside the bound; the fused FB loop beside its
               yardstick, the same rounds as K9 then K12 in one graph
               (``unfused_device_ms``); the LK GN and fused kernels on
               the configs' own input, the GN also on a random flow, with
               the mean GN steps a pixel runs (``gn_exit``), and the GN's
               device time on the path: the build then the GN in one graph,
               less the build alone;
               for the pair warp also one ``F.grid_sample`` call, its
               library yardstick, by event and by graph replay;
  6. graph   — the 19 configurations at 512^2 through
               ``compile.compiled_pipeline`` (one CUDA graph a shape), bit for
               bit against the eager flows of phase 4, the kernels counted
               during the capture equal to the eager path's, a second pair
               replayed in turns with the first, no launch counted at a
               replay; eager and graph in turns (event ms, host enqueue us),
               the graph's device time per pair and its capture time; one
               configuration per solver at 2048^2 as well;
  7. scan    — ``compile.scan_pipeline`` on 4 distinct pairs bit for bit
               against eager, and its pairs/s at K = 16 beside an eager loop;
  8. campaign — 30 pairs written as uncompressed 8-bit TIFFs plus one
               missing pair through ``harness.batch_runner.FlowBatchRunner``
               (batch 8, a ragged tail): a run, a resume, the batch with the
               missing pair in ``failed`` and the rest in ``done``, every
               ``.mat`` bit for bit against eager ``run_config`` on the
               decoded TIFFs; then the runner's pairs/s, compute wait and
               transfer + save time on a fresh campaign;
  9. parallel — the multi-GPU layer (``opticalflow_ri_tpu_torch.parallel``):
               K1 and K4/K5 with all 16 per-side ``edges`` masks against their
               plain versions at 47x61 and 333x517, bit for bit, and at the
               shapes, masks and step counts the ranks give them; K6 on a
               stripe's slab, K7 in global rows, K9 in stripe mode with each
               apron and K12 under the four y masks (both windows), bit for
               bit on stripes of 47x61 and 333x517 and on the ranks' own
               512x2048 stripes (``sharded_mode_parity``), and their device
               ms on an interior stripe beside the whole-image calls
               (``stripe_mode_ms``); then two
               groups of ranks spawned as ``chip_smoke.py --parallel-rank``
               (the kernels built once, here, before): one NCCL rank, and
               four gloo ranks sharing the one GPU (halos staged through
               host memory).  Each runs, at 2048^2 on
               ``particle_image_pair(seed=0)``, the kernel-sharded HS solve
               ((1, 2, 2) mesh), the rows-sharded Liu-Shen solve ((1, 4, 1),
               60 steps), ``batched_hs_pipeline`` ((2, 1, 2), two pairs) and
               route 1, ``sharded_pipeline_fn("HS_Fs3_4")`` ((1, 2, 2)), and the
               rows-sharded dense LK (``lk_solve_sharded_kernel``) and
               Farneback (``farneback_solve_sharded``) on (1, 4, 1), their
               launch and exchange counts zeroed just before each; rank 0
               gathers the tiles and holds them against the single-device
               port bit for bit (err to 1e-6 relative).  The four ranks also
               run ``batch_sharded_scan`` ((4, 1, 1), 16 pairs at 512^2,
               bit for bit against ``scan_pipeline``) and the runner with
               the mesh on the campaign's pairs (its ``done``/``failed`` and
               every ``.mat`` equal to the single-device runner's).  Rank 0
               times one sharded HS_Fs3_4, Liu-Shen, LK and FB solve beside
               the eager single-device calls, with the halo exchanges and
               kernel launches per solve; the four-rank times share one GPU
               and are no scaling figure.
               Both groups also run route 2, the sharded pyramid, eagerly
               (``sharded_pipeline_fn`` of every configuration but the
               single-level HS ones, on
               (1, 2, 2) tiles) at 512^2, and of one configuration a solver
               at 2048^2 (``ROUTE2_AT_2048``), every kernel count zeroed
               just before each run; rank 0 holds each against
               ``run_config`` on the card (AEE <= 5e-6, bit for bit
               named), checks that it launched exactly the configuration's
               kernels, and prints its exchanges, gathers and launches and
               its event and host ms beside the eager call's.  Every rank
               then runs the configuration again (not counted) with each
               kernel call also run through its plain version on copies
               of the same inputs, bit for bit
               (``kernels_against_plain``): the kernels are held at
               exactly the tiles, stripes, masks, aprons and step counts
               route 2 gives them, at both sizes and both levels, the
               gated Liu-Shen calls included.  The four gloo ranks check
               that ``auto_sharded_pipeline`` refuses their CUDA tiles,
               naming ``sharded_pipeline_fn``.  The one NCCL rank then
               replays the sharded pipeline as one CUDA graph a shape
               (``auto_sharded_pipeline(..., _force_sharded=True)``): all
               19 configurations at 512^2 and ``HS_Fs3_4`` with
               ``ROUTE2_AT_2048`` at 2048^2, each bit for bit against
               ``sharded_pipeline_fn`` and ``run_config``, no kernel counted
               at a replay (the capture itself shows that the path reads no
               tensor on the host, which would raise while the stream
               captures), and the event and host ms of the replay, the
               eager sharded call and ``compiled_pipeline``'s replay in 10
               turns (the ``kernels`` line counts, per kernel, the replayed
               runs whose capture launched it).  A
               failed rank stops the group and fails the phase.  Before
               the groups, K3's caller-padded mode is held against its
               plain version and the whole-image kernel cropped, bit for
               bit, under all 16 side combinations at 47x61, 333x517 and
               the ranks' 256^2 and 1024^2 tiles of 512^2 and 2048^2
               (``warp_padded_parity``), and timed beside the whole-image
               call (``warp_padded_ms``).
               Both groups then run the ``biLinear=False`` (Liu-Shen) warp
               on tiles, at 512^2 and 2048^2, on (1, 2, 2) and, with four
               ranks, (1, 4, 1): ``liu_shen_warp_sharded`` on three flows
               (``warp_flows``: sub-pixel, integers with collisions and
               wrap-around, one that crosses whole tiles), every rank's
               tile bit for bit the whole-image warp cropped, and its time
               at 2048^2 beside the whole-image warp's (one rank: also
               the device time of each as a replayed CUDA graph); then the
               two-level ``biLinear=False`` pyramids (``LS_WARP_PYRAMIDS``:
               an HS and a Liu-Shen adapter) under
               ``kernel_sharded_solvers``, the kernel counts zeroed just
               before each run, against the single-device driver (one
               rank bit for bit, four AEE <= 5e-6), launching K1 or K4/K5
               alone, each kernel call held against its plain version
               (``kernels_against_plain``).  The one NCCL rank replays each
               pyramid as one CUDA graph (``compile.CompiledPipeline``
               over the run on tiles), bit for bit against the eager
               sharded call and the single-device driver, with the replay,
               the eager sharded call and the single-device replay timed
               in turns.

A configuration whose graph replay is not bit for bit the eager result is
named with its difference and must stay within the whole-pipeline bar (AEE
<= 5e-6).  Any failure raises, so the exit code is non-zero and no result line is
printed.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches, error, times at 512^2, bound
(``kernel_costs``, ``bound_ms``) and library time (null where no single
PyTorch call computes the kernel's function).  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(ROOT, "opticalflow_ri_tpu_torch")
GOLDEN = os.path.join(ROOT, "tests", "golden", "synthetic96_flows.npz")

LS_ERR_BAR = 1e-5      # relative on the Liu-Shen err (u, v bitwise, k equal)
WARP_BAR_REL = 1e-5    # relative to the image's range
AEE_BAR = 5e-6         # card against the CPU plain path, whole pipeline
GOLDEN_BAR = 1e-3      # tests/test_golden.py
FB_GOLDEN_BAR = 2e-3   # tests/test_golden.py:test_fb_golden
FB_M_BAR = 1e-6        # the Farneback M, relative to max|M|
REPS = 15
REPS_2048 = 5          # the LK and FB kernels' A/B at 2048^2, where one plain call takes ~0.1 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
LK_CONFIGS = ("denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
              "LK_Fs2_0", "LK_Fs2_0_PyrLvls2")
CFG_INPUT = "configs' own: the wrapper's arguments in run_config('LK_Fs2_0')"
FB_CONFIGS = ("Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
              "FB_Fs0_0", "FB_Fs0_0_PyrLvls2")


def phase(name: str) -> None:
    print(f"# phase {name}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_costs(h: int, w: int, hs_niter: int = 100, gn_steps: float = 5,
                 fb_rounds: int = 5) -> dict:
    """(bytes, operations) of one call of each kernel on an h x w image, as
    the times phase calls it (HS at ``hs_niter`` iterations, LK at R = 5 and
    ``gn_steps`` GN steps per pixel on average, FB at R = 5, 33 taps and
    ``fb_rounds`` rounds of the fused loop, Liu-Shen at 60 steps):
    each input read once and each output written
    once; operations are the kernel's float arithmetic per pixel, from its
    source (HS: 27 per iteration and 5 for the reciprocal; warp: 36 per image;
    Liu-Shen: 68 per step; LK build: 1 product and 6 ladder adds per pass
    at the L = 27 window, per shift and gradient; LK GN: 8 gathered plane
    reads and ~60 operations per step the pixel runs (``gn_steps``: the
    kernels end a pixel's loop at its first inactive step); the fused LK
    build: the two-level sums' 10 adds per pass; FB updateMatrices ~100; FB
    blur + solve: 5 planes, 2 passes of 33 taps, a product and a sum each,
    and the solve; the fused loop: both a round, reading R0, R1 and the start
    flow and writing the flow, or at 0 rounds copying the flow; the FB
    expansion at polyN 7: 43 vertical and 87 horizontal taps, a product and
    a sum each, and 8 for the combinations, reading the source and writing
    the five planes)."""
    n = h * w
    core = (h + 31) * (w + 31)       # the LK gradient pair's planes
    slab = (h + 41) * (w + 41)       # the LK J slab at R = 5
    return {
        "hs_jacobi": (28 * n, (27 * hs_niter + 5) * n),
        "warp_pair": (32 * n, 72 * n),
        "liu_shen": (48 * n, 68 * 60 * n),                          # 60 steps
        "lk_build": (4 * (slab + 2 * core + 2 * 121 * n), 2 * 121 * 13 * n),
        "lk_gn": ((44 + 4 * 8 * gn_steps) * n, 60 * gn_steps * n),
        "lk_fused": (4 * (slab + 2 * core + 11 * n), (2 * 121 * 21 + 60 * gn_steps) * n),
        "fb_update_matrices": (68 * n, 100 * n),
        "fb_blur5_flow": (28 * n, (5 * 2 * 33 * 2 + 15) * n),
        "fb_fused": ((56 if fb_rounds else 16) * n, fb_rounds * (100 + 675) * n),
        "fb_poly_expand": (24 * n, (2 * (43 + 87) + 8) * n),
    }


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 peak, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def capture_lk_args(run_config, lk_build, lk_iter, name, im1, im2):
    """The arguments the LK build and GN wrappers receive during one
    ``run_config(name, im1, im2)``, their last call each: (build args, GN
    args).  The wrappers are swapped for recorders that call them, for this
    run only."""
    seen = {}
    saved = lk_build.lk_build_planes, lk_iter.lk_gn_iterate

    def recorder(key, fn):
        def record(*args):
            seen[key] = args
            return fn(*args)
        record.launches = fn.launches  # the wrapper counts through its module's name
        return record

    rec = recorder("build", saved[0]), recorder("gn", saved[1])
    lk_build.lk_build_planes, lk_iter.lk_gn_iterate = rec
    try:
        run_config(name, im1, im2)
    finally:
        lk_build.lk_build_planes, lk_iter.lk_gn_iterate = saved
        for fn, r in zip(saved, rec):
            fn.launches = r.launches
    return seen["build"], seen["gn"]


def gn_exit(lk_iter, t1, t2, ia11, ia12, ia22, c1, c2, act0, px0, py0, n_iter, R, hw):
    """The GN loop as ``csrc/lk_iter.cu`` runs it, pixel by pixel as a vector:
    each step runs the out-of-bounds bail on every pixel, then the rest of
    the step only on the pixels still active (the others keep their state and
    load nothing), and the loop ends when none is active.  Returns (px, py,
    status, steps): steps is the (h, w) int64 count of the steps each pixel
    ran (0: a singular window or a bail at the first step), which sets the
    kernels' bound.  tests/test_torch_kernel_plans.py holds (px, py, status)
    equal to ``lk_iter.lk_gn_iterate_plain`` bit for bit."""
    import torch

    nshift = 2 * R + 1
    h, w = ia11.shape
    dev = ia11.device
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ii = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    flat = [t.reshape(nshift * nshift, h * w) for t in (t1, t2)]
    offsets = torch.arange(h * w, device=dev).reshape(h, w)
    px, py, active = px0.clone(), py0.clone(), act0.clone()
    status = torch.ones((h, w), dtype=torch.float32, device=dev)
    steps = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for _ in range(int(n_iter)):
        oob = ((px < -hw) | (px >= w) | (py < -hw) | (py >= h)).to(torch.float32)
        status = status * (1.0 - active * oob)
        active = active * (1.0 - oob)
        live = active != 0
        if not bool(live.any()):
            break
        steps += live
        uc = (px[live] + hw - jj[live]).clamp(-R, lk_iter.clip_hi(R))
        vc = (py[live] + hw - ii[live]).clamp(-R, lk_iter.clip_hi(R))
        sx, sy = torch.floor(uc), torch.floor(vc)
        wx0 = (1.0 - (uc - sx).abs()).clamp_min(0.0)
        wx1 = (1.0 - (uc - (sx + 1.0)).abs()).clamp_min(0.0)
        wy0 = (1.0 - (vc - sy).abs()).clamp_min(0.0)
        wy1 = (1.0 - (vc - (sy + 1.0)).abs()).clamp_min(0.0)
        s00 = (sy.long() + R) * nshift + (sx.long() + R)
        at = offsets[live]
        sums = []
        for tf in flat:
            v = [tf[s00 + o, at] for o in (0, nshift, 1, nshift + 1)]
            sums.append(wx0 * (wy0 * v[0] + wy1 * v[1]) + wx1 * (wy0 * v[2] + wy1 * v[3]))
        b1, b2 = sums[0] - c1[live], sums[1] - c2[live]
        dx = (ia12[live] * b2 - ia22[live] * b1) * 32.0
        dy = (ia12[live] * b1 - ia11[live] * b2) * 32.0
        a = active[live]
        px[live] = px[live] + dx * a
        py[live] = py[live] + dy * a
        small = ((dx.abs() < lk_iter.STEP_EPS) & (dy.abs() < lk_iter.STEP_EPS)).to(torch.float32)
        active[live] = a * (1.0 - small)
    return px, py, status, steps


def expected_kernels(name: str) -> set:
    """The kernels a configuration's path launches, and no others.  The
    LK and FB configurations run with warping=False: no warp.
    LiuSE_LK_Fs2_0_* and LiuSE_FB_Fs0_0_* run Liu-Shen alone (the harness
    quirk of configs.py)."""
    if name == "lk_dense_solve_fused":
        return {"lk_fused"}
    if name == "fb_fused_solve":
        return {"fb_poly_expand", "fb_fused"}
    if name in LK_CONFIGS:
        return {"lk_build", "lk_gn"} | ({"liu_shen"} if name.startswith("LiuSE_") else set())
    if name in FB_CONFIGS:
        return ({"fb_poly_expand", "fb_update_matrices", "fb_blur5_flow"}
                | ({"liu_shen"} if name.startswith("LiuSE_") else set()))
    want = set()
    if not name.startswith("LiuSE_") or "HSchunck" in name:
        want.add("hs_jacobi")
    if name.startswith("LiuSE_"):
        want.add("liu_shen")
    if name.endswith("PyrLvls2"):
        want.add("warp_pair")
    return want


def write_tiff(path: str, im: np.ndarray) -> None:
    """An (H, W) uint8 image as an uncompressed little-endian grayscale TIFF,
    one strip: what PIV cameras write and the native decoder reads."""
    h, w = im.shape
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 1), (278, 4, h), (279, 4, h * w)]
    ifd = np.zeros(len(tags), dtype=[("tag", "<u2"), ("type", "<u2"), ("count", "<u4"),
                                     ("value", "<u4")])
    for i, (tag, typ, value) in enumerate(tags):
        ifd[i] = (tag, typ, 1, value)
    with open(path, "wb") as f:
        f.write(b"II" + np.array([42], "<u2").tobytes() + np.array([8], "<u4").tobytes())
        f.write(np.array([len(tags)], "<u2").tobytes() + ifd.tobytes())
        f.write(np.array([0], "<u4").tobytes())  # no next IFD
        f.write(np.ascontiguousarray(im, np.uint8).tobytes())


def aee(u, v, u_ref, v_ref) -> float:
    return float(np.mean(np.hypot(u - u_ref, v - v_ref)))


def to_np(t):
    return t.detach().cpu().numpy()


PARALLEL_SHAPE = (2048, 2048)
# route 2 at PARALLEL_SHAPE: one configuration a solver (HS, HS + Liu-Shen,
# LK, FB); at 512^2 every route-2 configuration runs
ROUTE2_KERNELS = ("hs_jacobi", "warp_pair", "liu_shen", "lk_build", "lk_gn", "fb_poly_expand",
                  "fb_update_matrices", "fb_blur5_flow")
ROUTE2_AT_2048 = ("HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2", "LK_Fs2_0_PyrLvls2",
                  "FB_Fs0_0_PyrLvls2")
PARALLEL_TIMEOUT_S = 420   # one spawned group, start-up included
# the two-level biLinear=False pyramids of the parallel phase: (pre-filter
# sigma, the port's adapter class, its arguments; the HS adapter's own
# defaults would set biLinear=True, so they are off), and the kernel each runs
LS_WARP_PYRAMIDS = {"hs": (3.4, "HSOpticalFlowAlgoAdapter", ([21.0, 45.0], 100, False)),
                    "ls": (0.0, "LiuShenOpticalFlowAlgoAdapter", (0.1,))}
LS_WARP_KERNELS = {"hs": "hs_jacobi", "ls": "liu_shen"}


def ls_warp_pyramid(name: str, mesh):
    """``run(im1, im2, device="cuda") -> (U, V)``: the two-level
    ``biLinear=False`` pyramid ``name`` of ``LS_WARP_PYRAMIDS`` with a fresh
    adapter, on this rank's tiles under ``kernel_sharded_solvers(mesh)``,
    or the single-device driver where ``mesh`` is None."""
    import opticalflow_ri_tpu_torch as port
    from opticalflow_ri_tpu_torch.parallel import kernel_sharded_solvers

    sigma, cls, args = LS_WARP_PYRAMIDS[name]

    def run(im1, im2, device="cuda"):
        with contextlib.nullcontext() if mesh is None else kernel_sharded_solvers(mesh):
            return port.generic_pyramidal_optical_flow(
                im1, im2, sigma, getattr(port, cls)(*args), pyramidalLevels=2, biLinear=False,
                device=device)

    return run


def warp_flows(shape, dev) -> dict:
    """Three flows for the Liu-Shen warp on tiles, from a seed: sub-pixel;
    integers of |d| <= 5 (collisions, and the top and left borders' negative
    flows wrapping to the far side); and about (0.55 W, -0.7 H), which
    crosses whole tiles."""
    import torch

    g = np.random.default_rng(11)
    h, w = shape
    flows = {"subpixel": (g.normal(0, 0.6, shape), g.normal(0, 0.6, shape)),
             "integer": (g.integers(-5, 6, shape), g.integers(-5, 6, shape)),
             "crossing": (0.55 * w + 3 * g.normal(size=shape),
                          -0.7 * h + 3 * g.normal(size=shape))}
    return {k: [torch.as_tensor(np.asarray(z, np.float32), device=dev) for z in f]
            for k, f in flows.items()}


def masked_parity(dev, rand, timed) -> dict:
    """K1 and K4/K5 with every ``edges`` mask against their plain versions on
    the card, bit for bit (the whole array, apron edges included): HS at 1,
    T-1 and T iterations, Liu-Shen at 1 and T steps with the stop (tol 0,
    k = max_iter) and at 2T + 1 steps with stop=False; then the shapes,
    masks and step counts that the parallel phase's ranks give them at
    2048^2, and ``timed``, the 2048^2 inputs of the masked device times
    (every side an apron edge).  Returns the largest difference per kernel
    (0 when bit for bit)."""
    import torch

    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, liu_shen_iter
    from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives

    t_hs, t_ls = hs_iter.STEPS_PER_LAUNCH, liu_shen_iter.STEPS_PER_LAUNCH
    worst = {"hs_jacobi": 0.0, "liu_shen": 0.0}
    bad = []

    def hs(fx, fy, ft, u0, v0, alpha, niter, edges):
        got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, alpha, niter, edges)
        want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, alpha, niter, edges)
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        worst["hs_jacobi"] = max(worst["hs_jacobi"], d)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad.append(("hs_jacobi", tuple(fx.shape), edges, niter, d))

    def ls(fields, u0, v0, n, edges, stop):
        got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, n, 0.0, edges, stop)
        want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, n, 0.0, edges, stop)
        d = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
        worst["liu_shen"] = max(worst["liu_shen"], d)
        same = all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
        if not (same and int(got[3]) == int(want[3]) == n):
            bad.append(("liu_shen", tuple(u0.shape), edges, n, stop, d, int(got[3]),
                        int(want[3])))
        if not stop and n and not bool(torch.isnan(got[2])):
            bad.append(("liu_shen err without the stop", edges, float(got[2])))

    def hs_input(shape):
        fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
        return fx, fy, ft, rand(shape, -2, 2), rand(shape, -2, 2)

    def ls_input(shape):
        a, b = rand(shape, 1, 255), rand(shape, 1, 255)
        return (liu_shen_precompute(a / a.max(), b / b.max(), 10.0), rand(shape, -0.5, 0.5),
                rand(shape, -0.5, 0.5))

    def verdict(what):
        torch.cuda.synchronize()
        print(f"masked kernels, {what}: max|d| {worst} (bar: bitwise) failures {bad or 'none'}",
              flush=True)
        if bad:
            raise AssertionError(f"masked kernels disagree with their plain versions: {bad}")

    for shape in [(47, 61), (333, 517)]:
        hs_in, ls_in = hs_input(shape), ls_input(shape)
        for edges in range(16):
            for niter in (1, t_hs - 1, t_hs):
                hs(*hs_in, 21.0, niter, edges)
            for n, stop in ((1, True), (t_ls, True), (2 * t_ls + 1, False)):
                ls(*ls_in, n, edges, stop)
        verdict(f"{shape}: 16 edges masks, HS at 1, {t_hs - 1}, {t_hs} iterations, Liu-Shen "
                f"at 1 and {t_ls} steps (stop) and {2 * t_ls + 1} (stop=False)")

    # the parallel phase's calls at 2048^2 (parallel/sharded_kernel.py): HS
    # tiles of the (1, 2, 2) mesh, 1024^2 and a T-deep apron on their two
    # interior sides, of the (2, 1, 2) mesh, 2048 x 1024 and one; the
    # 100-iteration solve runs launches of T and a last of 100 mod T
    big, (top, bot, left, right) = PARALLEL_SHAPE, (hs_iter.TOP, hs_iter.BOTTOM, hs_iter.LEFT,
                                                    hs_iter.RIGHT)
    hy, wx = big[0] // 2, big[1] // 2
    for shape, masks in (((hy + t_hs, wx + t_hs), (top | left, top | right, bot | left,
                                                   bot | right)),
                         ((big[0], wx + t_hs), (top | bot | left, top | bot | right))):
        tile = hs_input(shape)
        for edges in masks:
            for niter in sorted({t_hs, 100 % t_hs or t_hs}):
                hs(*tile, 21.0, niter, edges)
    # Liu-Shen stripes of the (1, 4, 1) mesh: 512 rows and the T-block's t
    # on each interior side, t - 1 steps then 1, without the stop
    from opticalflow_ri_tpu_torch.parallel.sharded_kernel import ls_shard_kernel_supported

    hl = big[0] // 4
    t = next(t for t in (16, 8, 4) if ls_shard_kernel_supported(hl, big[1], t))
    for rows, edges in ((hl + t, top | left | right), (hl + 2 * t, left | right),
                        (hl + t, bot | left | right)):
        stripe = ls_input((rows, big[1]))
        for n in (t - 1, 1):
            ls(*stripe, n, edges, False)
    del tile, stripe
    # the inputs timed in the parallel phase, every side an apron edge
    fx, fy, ft, z, fields = timed
    hs(fx, fy, ft, z, z, 1.0, 100, 0)
    ls(fields, z, z, 60, 0, False)
    verdict(f"the parallel path's calls at {big[0]}x{big[1]}: HS tiles {hy + t_hs}x{wx + t_hs} "
            f"and {big[0]}x{wx + t_hs} (their "
            f"four and two masks, {t_hs} and {100 % t_hs} iterations), Liu-Shen stripes {hl + t}x{big[1]} and "
            f"{hl + 2 * t}x{big[1]} ({t - 1} and 1 steps, stop=False); the timed "
            f"{big[0]}x{big[1]} inputs, edges 0: HS 100 iterations, Liu-Shen 60 steps")
    return worst


def sharded_mode_parity(dev, rand, fb_expansions) -> dict:
    """K6, K7, K9 and K12 in the sharded modes the rows-sharded LK and
    Farneback solves give them, against their plain versions on the card,
    bit for bit: stripes of 47x61 and 333x517 at the top, inside and at the
    bottom of an image three stripes deep, and the four ranks' own 512-row
    stripes of the 2048^2 inputs the parallel phase's ranks solve.  K6 on
    the stripe's slab (cut from the image padded by lk_pad rows, as the
    exchange gives it) and K7 in global rows (row0, img_h; at 0, 1 and 5
    steps, some pixels bailing at the image's bottom); K9 in stripe mode
    with each apron combination (none, R above, R below, both), calibrated
    and wild flows; K12 under the four y masks for the Gaussian and the box
    window.  Returns the largest difference per kernel (0 when bit for bit)."""
    import torch

    from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs_padded, lk_pad
    from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow as fb_blur
    from opticalflow_ri_tpu_torch.ops.cuda import lk_build, lk_iter, tent_sample
    from opticalflow_ri_tpu_torch.ops.cuda.hs_iter import BOTTOM, TOP
    from opticalflow_ri_tpu_torch.ops.padding import pad2d
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    R, HW, pad = 5, 13, lk_pad(5)
    worst = dict.fromkeys(("lk_build", "lk_gn", "fb_update_matrices", "fb_blur5_flow"), 0.0)
    bad = []
    windows = {"gaussian": _window_blur_spec(33, True), "box": _window_blur_spec(33, False)}

    def check(name, label, got, want):
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        worst[name] = max(worst[name], d)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad.append((name, label, d))

    def cases(img_h, h):
        """(row0, a_top, a_bot) of an image's stripes of h rows: R-row
        aprons on the interior sides; the whole image as one stripe too."""
        out = [(row0, R if row0 else 0, R if row0 + h < img_h else 0)
               for row0 in range(0, img_h, h)]
        return out + [(0, 0, 0)] if img_h > h else out

    def lk_stripes(a, b, h, flows):
        """K6 and K7 on each h-row stripe of the (img_h, w) pair a, b."""
        img_h, w = a.shape
        ap, bp = (pad2d(x, pad, "nearest") for x in (a, b))
        for row0 in range(0, img_h, h):
            rows = slice(row0, row0 + h + 2 * pad)
            for k, (fname, (u0, v0), steps) in enumerate(flows):
                slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs_padded(
                    ap[rows], bp[rows], u0[row0 : row0 + h], v0[row0 : row0 + h], HW,
                    (0, 0, 0, 0), R, row0)
                label = f"{h}x{w} stripe at row {row0} of {img_h}, {fname}"
                if k == 0:  # the planes do not depend on the flow
                    t = lk_build.lk_build_planes(slab, g_pair, HW, R, runs_y, runs_x)
                    check("lk_build", label, t,
                          lk_build.lk_build_planes_plain(slab, g_pair, HW, R, runs_y, runs_x))
                for n in steps:
                    check("lk_gn", f"{label}, {n} steps",
                          lk_iter.lk_gn_iterate(*t, *fields, n, R, HW, row0=row0, img_h=img_h,
                                                img_w=w),
                          lk_iter.lk_gn_iterate_plain(*t, *fields, n, R, HW, row0=row0,
                                                      img_h=img_h, img_w=w))
                del slab, g_pair, fields
            del t
            torch.cuda.empty_cache()

    def fb_stripes(r0, r1, h, flows):
        """K9 with each apron and K12 under each mask on the h-row stripes of
        the (5, img_h, w) expansions."""
        img_h = r0.shape[1]
        for fname, (fx, fy) in flows:
            m_all = tent_sample.update_matrices_plain(fx, fy, r0, r1)
            for row0, a_top, a_bot in cases(img_h, h):
                hh = img_h if (row0, a_top, a_bot) == (0, 0, 0) else h
                rows = slice(row0, row0 + hh)
                label = f"{hh}x{r0.shape[2]} stripe at row {row0} of {img_h}, {fname}"
                args = (fx[rows], fy[rows], r0[:, rows].contiguous(),
                        r1[:, row0 - a_top : row0 + hh + a_bot].contiguous(), R)
                kw = dict(row0=row0, img_rows=img_h, apron=(a_top, a_bot))
                check("fb_update_matrices", f"{label}, apron {(a_top, a_bot)}",
                      [tent_sample.update_matrices(*args, **kw)],
                      [tent_sample.update_matrices_plain(*args, **kw)])
                for wname, (taps, mode, scale) in windows.items():
                    half = len(taps) // 2
                    edges = (TOP if row0 == 0 else 0) | (BOTTOM if row0 + hh == img_h else 0)
                    lo, hi = row0 - (0 if edges & TOP else half), \
                        row0 + hh + (0 if edges & BOTTOM else half)
                    m = m_all[:, lo:hi].contiguous()
                    check("fb_blur5_flow", f"{label}, {wname}, edges {edges}",
                          fb_blur.blur5_flow(m, taps, mode, scale, edges),
                          fb_blur.blur5_flow_plain(m, taps, mode, scale, edges))
            del m_all
            torch.cuda.empty_cache()

    def verdict(what):
        torch.cuda.synchronize()
        print(f"sharded modes, {what}: max|d| {worst} (bar: bitwise) failures {bad or 'none'}",
              flush=True)
        if bad:
            raise AssertionError(f"sharded kernel modes disagree with their plain versions: {bad}")

    for h, w in [(47, 61), (333, 517)]:
        img = (3 * h, w)
        a = rand(img, 0, 255)
        b = torch.roll(a, (1, 2), (0, 1)) + rand(img, -2, 2)
        v_bail = rand(img, -4, 4)
        v_bail[-8:, ::3] = 14.5  # origins at or past the image's bottom: they bail
        lk_stripes(a, b, h, [("calibrated |d|<=4", (rand(img, -4, 4), rand(img, -4, 4)),
                              (0, 1, 5)),
                             ("bottom bails", (rand(img, -4, 4), v_bail), (1, 5))])
        r0, r1 = fb_expansions(img)
        fb_stripes(r0, r1, h, [("calibrated |d|<=4", (rand(img, -4, 4), rand(img, -4, 4))),
                               ("wild |d|<=20", (rand(img, -20, 20), rand(img, -20, 20)))])
        verdict(f"stripes of {h}x{w} in a {img[0]}-row image")
        del a, b, r0, r1

    # the ranks' own stripes: the parallel phase's 2048^2 pair, zero flow
    big, hl = PARALLEL_SHAPE, PARALLEL_SHAPE[0] // 4
    a, b = (torch.as_tensor(im, device=dev)
            for im in particle_image_pair(shape=big, seed=0)[:2])
    z = torch.zeros(big, device=dev)
    lk_stripes(a, b, hl, [("zero flow (the ranks' call)", (z, z), (5,))])
    del a, b
    r0, r1 = fb_expansions(big)
    fb_stripes(r0, r1, hl, [("zero flow", (z, z)),
                            ("calibrated |d|<=4", (rand(big, -4, 4), rand(big, -4, 4)))])
    del r0, r1, z
    torch.cuda.empty_cache()
    verdict(f"the ranks' {hl}x{big[1]} stripes of {big[0]}x{big[1]}")
    return worst


def warp_padded_parity(rand) -> float:
    """K3 in its caller-padded mode (the sharded pyramid's warp) against its
    plain version and against the whole-image kernel cropped to the tile,
    bit for bit, under all 16 combinations of border and interior sides:
    tiles of 47x61 and 333x517 images, and the (1, 2, 2) ranks' 256^2 and
    1024^2 tiles of the 512^2 and 2048^2 images (an interior side at the
    middle row or column; a side pair that is all border spans the image),
    calibrated (|d| <= 4) and wild (|d| <= 12, beyond R = 8) flows.  Each tile's images are cut
    from the image padded by R cells in mode "nearest", as the exchange
    gives them.  Returns the largest difference (0 when bit for bit)."""
    import itertools

    import torch

    from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
    from opticalflow_ri_tpu_torch.ops.padding import pad2d

    a, worst, bad = 8, 0.0, []

    def spans(n, lo_border, hi_border):
        if n in (512, PARALLEL_SHAPE[0]):   # the ranks' halves, or the middle half
            return {(True, True): (0, n), (True, False): (0, n // 2),
                    (False, True): (n // 2, n), (False, False): (n // 4, 3 * n // 4)}[
                        (lo_border, hi_border)]
        return (0 if lo_border else n // 4, n if hi_border else n - n // 5)

    for shape in [(47, 61), (333, 517), (512, 512), PARALLEL_SHAPE]:
        h, w = shape
        for fname, dmax in (("calibrated |d|<=4", 4.0), ("wild |d|<=12", 12.0)):
            ims = [rand(shape, 0, 255) for _ in range(2)]
            flows = [rand(shape, -dmax, dmax) for _ in range(4)]
            whole = warp_tent.warp_pair(*ims, *flows)
            padded = [pad2d(im, a, "nearest") for im in ims]
            for top, bottom, left, right in itertools.product((True, False), repeat=4):
                r0, r1 = spans(h, top, bottom)
                c0, c1 = spans(w, left, right)
                tiles = [p[r0:r1 + 2 * a, c0:c1 + 2 * a].contiguous() for p in padded]
                cut = [f[r0:r1, c0:c1].contiguous() for f in flows]
                tile = dict(apron=a, row0=r0, col0=c0, img_h=h, img_w=w)
                got = warp_tent.warp_pair(*tiles, *cut, **tile)
                plain = warp_tent.warp_pair_plain(*tiles, *cut, **tile)
                for g, p, want in zip(got, plain, whole):
                    d = max(float((g - p).abs().max()), float((g - want[r0:r1, c0:c1]).abs().max()))
                    worst = max(worst, d)
                    if not (torch.equal(g, p) and torch.equal(g, want[r0:r1, c0:c1])):
                        bad.append((shape, fname, (top, bottom, left, right), d))
            del ims, flows, whole, padded
    torch.cuda.synchronize()
    print(f"warp_pair caller-padded mode (apron {a}), 16 side combinations at 47x61, 333x517 "
          f"and the ranks' 256^2 and 1024^2 tiles of 512^2 and {PARALLEL_SHAPE[0]}^2, calibrated "
          f"and wild flows: "
          f"max|d| {worst} against its plain version and the whole-image kernel cropped "
          f"(bar: bitwise) failures {bad or 'none'}", flush=True)
    if bad:
        raise AssertionError(f"warp_pair's padded mode disagrees: {bad}")
    return worst


def warp_padded_ms(rand, device_ms) -> dict:
    """K3's device ms (graph replay): the padded mode on an interior 1024^2
    tile of the 2048^2 image (the neighbours' cells on every side) beside
    the whole-image call on a 1024^2 image and on the 2048^2 one."""
    from opticalflow_ri_tpu_torch.ops.cuda import warp_tent
    from opticalflow_ri_tpu_torch.ops.padding import pad2d

    a, (h, w) = 8, PARALLEL_SHAPE
    th, tw = h // 2, w // 2
    ims = [rand(PARALLEL_SHAPE, 0, 255) for _ in range(2)]
    flows = [rand(PARALLEL_SHAPE, -4, 4) for _ in range(4)]
    r0, c0 = h // 4, w // 4
    tiles = [pad2d(im, a, "nearest")[r0:r0 + th + 2 * a, c0:c0 + tw + 2 * a].contiguous()
             for im in ims]
    cut = [f[r0:r0 + th, c0:c0 + tw].contiguous() for f in flows]
    tile = dict(apron=a, row0=r0, col0=c0, img_h=h, img_w=w)
    small = [im[r0:r0 + th, c0:c0 + tw].contiguous() for im in ims]
    return {f"padded, interior {th}x{tw} tile of {h}x{w}": device_ms(
                lambda: warp_tent.warp_pair(*tiles, *cut, **tile), 50),
            f"whole image {th}x{tw}": device_ms(lambda: warp_tent.warp_pair(*small, *cut), 50),
            f"whole image {h}x{w}": device_ms(lambda: warp_tent.warp_pair(*ims, *flows), 50)}


def stripe_mode_ms(dev, rand, fb_expansions, device_ms) -> dict:
    """The device ms (graph replay) of K7, K9 and K12 in their sharded modes on
    an interior 512 x 2048 stripe of the 2048^2 image (row0 512, the
    neighbours' rows on both sides), each beside the whole-image call on the
    same rows: K7 on a random |d| <= 4 flow (5 steps), K9 on a calibrated
    flow, K12 with the 33-tap Gaussian."""
    import torch

    from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec
    from opticalflow_ri_tpu_torch.models.lucas_kanade import (
        lk_kernel_inputs, lk_kernel_inputs_padded, lk_pad,
    )
    from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow as fb_blur
    from opticalflow_ri_tpu_torch.ops.cuda import lk_build, lk_iter, tent_sample
    from opticalflow_ri_tpu_torch.ops.padding import pad2d

    img_h, w = PARALLEL_SHAPE
    hl, R, pad = img_h // 4, 5, lk_pad(5)
    shape = (hl, w)
    a = rand(shape, 0, 255)
    b = torch.roll(a, (1, 2), (0, 1)) + rand(shape, -2, 2)
    u0, v0 = rand(shape, -4, 4), rand(shape, -4, 4)
    slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(a, b, u0, v0)
    t = lk_build.lk_build_planes(slab, g_pair, 13, R, runs_y, runs_x)
    stripe = lk_kernel_inputs_padded(pad2d(a, pad, "nearest"), pad2d(b, pad, "nearest"), u0, v0,
                                     13, (0, 0, 0, 0), R, hl)[2]
    out = {"lk_gn random, stripe row0 512": device_ms(
               lambda: lk_iter.lk_gn_iterate(*t, *stripe, 5, R, 13, row0=hl, img_h=img_h,
                                             img_w=w), 20),
           "lk_gn random, whole": device_ms(lambda: lk_iter.lk_gn_iterate(*t, *fields, 5, R, 13),
                                            20)}
    del slab, g_pair, fields, stripe, t
    r0, r1 = fb_expansions((hl + 2 * R, w))
    fx, fy = rand(shape, -4, 4), rand(shape, -4, 4)
    r0 = r0[:, R : R + hl].contiguous()
    out["fb_update_matrices, stripe apron (5, 5)"] = device_ms(
        lambda: tent_sample.update_matrices(fx, fy, r0, r1, R, row0=hl, img_rows=img_h,
                                            apron=(R, R)), 50)
    r1w = r1[:, R : R + hl].contiguous()
    out["fb_update_matrices, whole"] = device_ms(
        lambda: tent_sample.update_matrices(fx, fy, r0, r1w, R), 50)
    taps, mode, scale = _window_blur_spec(33, True)
    half = len(taps) // 2
    m = tent_sample.update_matrices_plain(*(rand((hl + 2 * half, w), -4, 4) for _ in range(2)),
                                          *fb_expansions((hl + 2 * half, w)))
    mw = m[:, half : half + hl].contiguous()
    out["fb_blur5_flow gaussian 33, interior mask"] = device_ms(
        lambda: fb_blur.blur5_flow(m, taps, mode, scale, 0), 50)
    out["fb_blur5_flow gaussian 33, whole"] = device_ms(
        lambda: fb_blur.blur5_flow(mw, taps, mode, scale), 50)
    return out


@contextlib.contextmanager
def kernels_against_plain(swaps: dict, record: dict):
    """While active, every call of a kernel wrapper named in ``swaps``
    ({name: (module, attribute)}, the attribute the path calls) launches
    the kernel as the path does and also runs the wrapper's plain version
    on copies of the same inputs, made before the kernel ran, and holds the
    two bit for bit (NaN equal to NaN; Liu-Shen's u, v and k, as
    ``masked_parity``: its err is not read without the stop).  So the
    kernels are checked at exactly the shapes, masks, aprons and step
    counts of the calls a run makes.  ``record[name]`` gathers the calls,
    their distinct (shape, arguments) signatures and the largest
    difference; a disagreement raises when the context ends."""
    import torch

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(y) for y in x)
        return x

    def outputs(x):
        return list(x) if isinstance(x, (tuple, list)) else [x]

    def shape_of(a):
        if isinstance(a, (tuple, list)) and a and isinstance(a[0], torch.Tensor):
            a = a[0]   # Liu-Shen's fields
        return tuple(a.shape) if isinstance(a, torch.Tensor) else None

    def label(args, kw):
        shapes = [shape_of(a) for a in args if shape_of(a)]
        rest = [f"array{a.shape}" if isinstance(a, np.ndarray) else a for a in args
                if shape_of(a) is None]
        return f"{shapes[0]} {rest}" + (f" {kw}" if kw else "")

    bad = []

    def checking(name, wrapper, plain):
        def run(*args, **kw):
            copies, kw_copies = clone(args), {k: clone(v) for k, v in kw.items()}
            got = wrapper(*args, **kw)
            want = plain(*copies, **kw_copies)
            rec = record.setdefault(name, {"calls": 0, "max_abs_diff": 0.0, "signatures": []})
            rec["calls"] += 1
            sig = label(args, kw)
            if sig not in rec["signatures"]:
                rec["signatures"].append(sig)
            pairs = list(zip(outputs(got), outputs(want)))
            if name == "liu_shen":
                pairs = [pairs[0], pairs[1], pairs[3]]
            for g, w in pairs:
                if not isinstance(g, torch.Tensor):
                    ok, d = g == w, 0.0
                elif g.shape != w.shape:
                    ok, d = False, float("inf")
                else:
                    same_nan = torch.equal(torch.isnan(g), torch.isnan(w))
                    gz, wz = torch.nan_to_num(g, 0.0), torch.nan_to_num(w, 0.0)
                    ok = same_nan and torch.equal(gz, wz)
                    d = float((gz.double() - wz.double()).abs().max()) if g.numel() else 0.0
                rec["max_abs_diff"] = max(rec["max_abs_diff"], d)
                if not ok:
                    bad.append((name, sig, d))
            del copies, kw_copies, want
            return got
        # the wrapper counts its launches on the module's attribute, which
        # is ``run`` while this context holds: a copy of its attributes
        # takes them, and the path's own counts stay as they were
        return functools.update_wrapper(run, wrapper)

    saved = {name: getattr(mod, attr) for name, (mod, attr) in swaps.items()}
    for name, (mod, attr) in swaps.items():
        setattr(mod, attr, checking(name, saved[name], getattr(mod, attr + "_plain")))
    try:
        yield record
    finally:
        for name, (mod, attr) in swaps.items():
            setattr(mod, attr, saved[name])
    if bad:
        raise AssertionError(f"route 2's kernel calls disagree with their plain versions: "
                             f"{bad[:8]}")


def rank_main(argv) -> None:
    """One rank of a group spawned by the parallel phase: ``chip_smoke.py
    --parallel-rank R WORLD BACKEND INIT WORK``.  Runs the sharded entry
    points at 2048^2 on this rank's tiles, gathers them to rank 0, which
    holds them against the single-device port on the same card and prints
    one JSON line per check; any disagreement raises (non-zero exit)."""
    import torch

    rank, world, backend, init, work = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, ROOT)
    from opticalflow_ri_tpu_torch.compile import scan_pipeline
    from opticalflow_ri_tpu_torch.configs import CONFIGS, run_config
    from opticalflow_ri_tpu_torch.models.farneback import farneback_solve
    from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve
    from opticalflow_ri_tpu_torch.ops.cuda import (
        blur5_flow, hs_iter, liu_shen_iter, lk_build, lk_iter, poly_expand, tent_sample, warp_tent,
    )
    from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
    from opticalflow_ri_tpu_torch.parallel import (
        batch_sharded_scan, batch_sharding, batched_hs_pipeline, distributed, exchange_halo,
        farneback_solve_sharded, gather_axis, hs_solve_sharded, liu_shen_solve_sharded,
        lk_solve_sharded_kernel, make_mesh,
    )
    from opticalflow_ri_tpu_torch.parallel.auto import (
        HS_SINGLE_LEVEL, auto_sharded_pipeline, sharded_pipeline_fn,
    )
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    distributed.initialize(init, world, rank, backend=backend)
    assert "jax" not in sys.modules, "the port imported jax"
    dev = torch.device("cuda", torch.cuda.current_device())
    lead = rank == 0
    one = world == 1
    label = ("one NCCL rank" if one else f"{world} {backend} ranks sharing one GPU "
             f"({torch.cuda.get_device_name(0)})")

    def report(rec):
        if lead:
            print(json.dumps({"group": label, **rec}), flush=True)

    def mesh(shape):
        return make_mesh(shape=(1, 1, 1) if one else shape)

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def rel(e, e_ref):
        e, e_ref = float(e), float(e_ref)
        return abs(e - e_ref) / abs(e_ref) if e_ref else abs(e)

    def check(name, ok, rec):
        report({"check": name, "ok": bool(ok), **rec})
        if lead and not ok:
            raise AssertionError(f"{label}: {name} disagrees with the single-device port: {rec}")

    shape = PARALLEL_SHAPE
    pair = [torch.as_tensor(im, device=dev) for im in particle_image_pair(shape, seed=0)[:2]]
    pair1 = [torch.as_tensor(im, device=dev) for im in particle_image_pair(shape, seed=1)[:2]]
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    spec = ("y", "x")

    def counts():
        return (hs_iter.hs_iterate.launches, liu_shen_iter.liu_shen_iterate.launches,
                exchange_halo.exchanges)

    def per_call(before):
        return dict(zip(("hs_iterate_launches", "liu_shen_iterate_launches", "halo_exchanges"),
                        (a - b for a, b in zip(counts(), before))))

    # Horn-Schunck on the kernel, ("y", "x") tiles
    m_hs = mesh((1, 2, 2))
    sl = distributed.local_slices(m_hs, shape, spec)
    before = counts()
    u, v, err = hs_solve_sharded(m_hs, pair[0][sl], pair[1][sl], 21.0, 100, zero[sl], zero[sl])
    used = per_call(before)
    u, v = (distributed.gather_global(m_hs, t, spec) for t in (u, v))
    if lead:
        ref = hs_solve(*pair, 21.0, 100, zero, zero)
        check("hs_solve_sharded (kernel), alpha 21, 100 iterations", same((u, v), ref[:2])
              and rel(err, ref[2]) <= 1e-6 and used["hs_iterate_launches"] > 0,
              {"bitwise": same((u, v), ref[:2]), "err": float(err), "single_err": float(ref[2]),
               "err_rel": rel(err, ref[2]), "mesh": list(m_hs.shape), **used})

    # Liu-Shen on the kernel, ("y", None) stripes: tol 0 runs all 60 steps
    m_ls = mesh((1, 4, 1))
    sl = distributed.local_slices(m_ls, shape, ("y", None))
    before = counts()
    u, v, err = liu_shen_solve_sharded(m_ls, pair[0][sl], pair[1][sl], 10.0, zero[sl], zero[sl],
                                       max_iter=60, tol=0.0)
    used = per_call(before)
    u, v = (distributed.gather_global(m_ls, t, ("y", None)) for t in (u, v))
    if lead:
        a, b = pair
        fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
        ref = liu_shen_iter.liu_shen_iterate(10.0, fields, zero, zero, 60, 0.0)
        check("liu_shen_solve_sharded (kernel), h 10, 60 steps, tol 0",
              same((u, v), ref[:2]) and int(ref[3]) == 60 and rel(err, ref[2]) <= 1e-6
              and used["liu_shen_iterate_launches"] > 0,
              {"bitwise": same((u, v), ref[:2]), "single_k": int(ref[3]), "err": float(err),
               "single_err": float(ref[2]), "err_rel": rel(err, ref[2]),
               "mesh": list(m_ls.shape), **used})

    # the batched pipeline: two pairs over 'batch', tiles over (y, x)
    m_b = mesh((2, 1, 2))
    stack = [torch.stack([pair[i], pair1[i]]) for i in (0, 1)]
    sl = distributed.local_slices(m_b, (2, *shape), distributed.SPEC_BATCH)
    before = counts()
    u, v, err = batched_hs_pipeline(m_b, stack[0][sl], stack[1][sl], alpha=21.0, niter=100)
    used = per_call(before)
    u, v = (distributed.gather_global(m_b, t, distributed.SPEC_BATCH) for t in (u, v))
    errs = [None] * world
    torch.distributed.all_gather_object(errs, (sl[0].start, err.cpu().tolist()))
    if lead:
        err_of = {start + i: e for start, es in errs for i, e in enumerate(es)}
        for k, p in enumerate((pair, pair1)):
            f = [gaussian_filter_px(im, 3.4, 3) for im in p]
            ref = hs_solve(*f, 21.0, 100, zero, zero)
            check(f"batched_hs_pipeline pair {k}, sigma 3.4, alpha 21, 100 iterations",
                  same((u[k], v[k]), ref[:2]) and rel(err_of[k], ref[2]) <= 1e-6
                  and used["hs_iterate_launches"] > 0,
                  {"bitwise": same((u[k], v[k]), ref[:2]), "err": err_of[k],
                   "single_err": float(ref[2]), "mesh": list(m_b.shape), **used})

    # route 1, run eagerly (sharded_pipeline_fn), against run_config
    fn = sharded_pipeline_fn("HS_Fs3_4", m_hs)
    sl = distributed.local_slices(m_hs, shape, spec)
    tiles = [im[sl].contiguous() for im in pair]
    before = counts()
    u, v = fn(*tiles)
    used = per_call(before)
    u, v = (distributed.gather_global(m_hs, t, spec) for t in (u, v))
    if lead:
        ref = run_config("HS_Fs3_4", *pair)
        d = max(float((g - w).abs().max()) for g, w in zip((u, v), ref))
        e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
        check("sharded_pipeline_fn('HS_Fs3_4') route 1 against run_config",
              (same((u, v), ref) or e <= AEE_BAR) and used["hs_iterate_launches"] > 0,
              {"bitwise": same((u, v), ref), "max_abs_diff": d, "aee": e,
               "mesh": list(m_hs.shape), **used})

    # rows-sharded dense LK and Farneback on ("y", None) stripes: the
    # launch and exchange counts set to 0 just before each solve, read just
    # after (this slice's path)
    rows = ("y", None)
    m_rows = mesh((1, 4, 1))
    sl = distributed.local_slices(m_rows, shape, rows)
    row_tiles = [t[sl].contiguous() for t in (pair[0], pair[1], zero, zero)]
    path_wrappers = {"lk_build": lk_build.lk_build_planes, "lk_gn": lk_iter.lk_gn_iterate,
                     "fb_poly_expand": poly_expand.poly_expand,
                     "fb_update_matrices": tent_sample.update_matrices,
                     "fb_blur5_flow": blur5_flow.blur5_flow}

    def on_zeroed_counts(call):
        for wrapper in path_wrappers.values():
            wrapper.launches = 0
        exchange_halo.exchanges = 0
        out = call()
        return out, {"halo_exchanges": exchange_halo.exchanges,
                     **{f"{k}_launches": f.launches for k, f in path_wrappers.items()}}

    def max_diff(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    lk_call = lambda: lk_solve_sharded_kernel(m_rows, *row_tiles)  # noqa: E731
    fb_call = lambda: farneback_solve_sharded(m_rows, *row_tiles)  # noqa: E731
    got, lk_used = on_zeroed_counts(lk_call)
    got = [distributed.gather_global(m_rows, t, rows) for t in got]
    if lead:
        ref = lk_dense_solve(*pair, zero, zero)
        check("lk_solve_sharded_kernel, half window 13, 5 steps, R 5, against lk_dense_solve",
              same(got, ref) and lk_used["lk_build_launches"] > 0
              and lk_used["lk_gn_launches"] > 0,
              {"bitwise": same(got, ref), "max_abs_diff": max_diff(got, ref),
               "mesh": list(m_rows.shape), **lk_used})
        del ref
    got, fb_used = on_zeroed_counts(fb_call)
    got = [distributed.gather_global(m_rows, t, rows) for t in got]
    if lead:
        ref = farneback_solve(*pair, zero, zero)
        check("farneback_solve_sharded, window 33 Gaussian, 5 iterations, against "
              "farneback_solve", same(got, ref) and fb_used["fb_update_matrices_launches"] > 0
              and fb_used["fb_blur5_flow_launches"] > 0,
              {"bitwise": same(got, ref), "max_abs_diff": max_diff(got, ref),
               "mesh": list(m_rows.shape), **fb_used})
        del ref
    del got
    torch.cuda.empty_cache()

    # times: CUDA events, and the host's time in the call (the card idle
    # before it); every rank in step, or rank 0 alone
    def timed(call, reps=5, together=True):
        ev, host = [], []
        for _ in range(reps):
            if together:
                torch.distributed.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            call()
            host.append(1e3 * (time.perf_counter() - t0))
            end.record()
            end.synchronize()
            ev.append(start.elapsed_time(end))
        return statistics.median(ev), statistics.median(host)

    def graph_ms(call, replays=10):
        """The call captured in a CUDA graph and replayed back to back: its
        device time without the host (one rank: no collective, no host read
        in route 1)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / replays

    ls_tiles = [im[distributed.local_slices(m_ls, shape, ("y", None))].contiguous()
                for im in (*pair, zero)]
    t_hs = timed(lambda: fn(*tiles))
    before = counts()
    fn(*tiles)
    hs_used = per_call(before)
    t_ls = timed(lambda: liu_shen_solve_sharded(m_ls, *ls_tiles[:2], 10.0, ls_tiles[2],
                                                ls_tiles[2], max_iter=60, tol=0.0))
    before = counts()
    liu_shen_solve_sharded(m_ls, *ls_tiles[:2], 10.0, ls_tiles[2], ls_tiles[2], max_iter=60,
                           tol=0.0)
    ls_used = per_call(before)
    t_lk = timed(lk_call)
    t_fb = timed(fb_call)
    torch.distributed.barrier()
    if lead:
        from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_solve

        t_hs1 = timed(lambda: run_config("HS_Fs3_4", *pair), together=False)
        t_ls1 = timed(lambda: liu_shen_solve(*pair, 10.0, zero, zero, 60, 0.0), together=False)
        t_lk1 = timed(lambda: lk_dense_solve(*pair, zero, zero), together=False)
        t_fb1 = timed(lambda: farneback_solve(*pair, zero, zero), together=False)
        device = {}
        if one:
            device = {"sharded_hs_fs3_4_graph_device_ms": graph_ms(lambda: fn(*tiles)),
                      "eager_hs_fs3_4_graph_device_ms": graph_ms(
                          lambda: run_config("HS_Fs3_4", *pair)),
                      "sharded_lk_graph_device_ms": graph_ms(lk_call),
                      "eager_lk_graph_device_ms": graph_ms(
                          lambda: lk_dense_solve(*pair, zero, zero)),
                      "sharded_fb_graph_device_ms": graph_ms(fb_call),
                      "eager_fb_graph_device_ms": graph_ms(
                          lambda: farneback_solve(*pair, zero, zero))}
        report({"times": "HS_Fs3_4, the Liu-Shen solve (h 10, 60 steps, tol 0), dense LK "
                         "(half window 13, 5 steps) and Farneback (window 33, 5 iterations) at "
                         f"{shape[0]}x{shape[1]}, CUDA-event ms on rank 0, host ms in the call",
                "sharded_hs_fs3_4_ms": t_hs[0], "sharded_hs_fs3_4_host_ms": t_hs[1],
                "eager_hs_fs3_4_ms": t_hs1[0], "eager_hs_fs3_4_host_ms": t_hs1[1],
                "sharded_liu_shen_ms": t_ls[0], "sharded_liu_shen_host_ms": t_ls[1],
                "eager_liu_shen_ms": t_ls1[0], "eager_liu_shen_host_ms": t_ls1[1],
                "sharded_lk_ms": t_lk[0], "sharded_lk_host_ms": t_lk[1],
                "eager_lk_ms": t_lk1[0], "eager_lk_host_ms": t_lk1[1],
                "sharded_fb_ms": t_fb[0], "sharded_fb_host_ms": t_fb[1],
                "eager_fb_ms": t_fb1[0], "eager_fb_host_ms": t_fb1[1], **device,
                "hs_per_solve": hs_used, "liu_shen_per_solve": ls_used,
                "lk_per_solve": lk_used, "fb_per_solve": fb_used,
                "meshes": {"hs": list(m_hs.shape), "liu_shen": list(m_ls.shape),
                           "lk_fb": list(m_rows.shape)},
                "note": ("one rank: the sharded schedule on one GPU" if one else
                         "four ranks share one H100: not a scaling figure")})
    torch.distributed.barrier()

    # route 2, the sharded pyramid (this slice's path): every configuration
    # but the single-level HS ones at 512^2 and one a solver at 2048^2, on
    # ("y", "x") tiles of (1, 2, 2), against run_config on the card; every
    # kernel wrapper's count, the exchanges and the gathers set to 0 just
    # before each run and read just after
    route2_wrappers = {"hs_jacobi": hs_iter.hs_iterate, "warp_pair": warp_tent.warp_pair,
                       "liu_shen": liu_shen_iter.liu_shen_iterate, **path_wrappers}
    route2_swaps = {"hs_jacobi": (hs_iter, "hs_iterate"), "warp_pair": (warp_tent, "warp_pair"),
                    "liu_shen": (liu_shen_iter, "liu_shen_iterate"),
                    "lk_build": (lk_build, "lk_build_planes"), "lk_gn": (lk_iter, "lk_gn_iterate"),
                    "fb_poly_expand": (poly_expand, "poly_expand"),
                    "fb_update_matrices": (tent_sample, "update_matrices"),
                    "fb_blur5_flow": (blur5_flow, "blur5_flow")}

    def route2_counts(call):
        for wrapper in route2_wrappers.values():
            wrapper.launches = 0
        exchange_halo.exchanges = gather_axis.gathers = 0
        out = call()
        return out, {"halo_exchanges": exchange_halo.exchanges, "gathers": gather_axis.gathers,
                     **{f"{k}_launches": f.launches for k, f in route2_wrappers.items()}}

    m_r2 = mesh((1, 2, 2))
    if not one:
        # the graph-replaying entry refuses CUDA tiles on gloo, naming the
        # eager one, which runs every check of this group
        try:
            auto_sharded_pipeline("HS_Fs3_4", m_r2)(*tiles)
            raised = None
        except ValueError as err:
            raised = str(err)
        check("auto_sharded_pipeline on CUDA tiles over gloo raises, naming sharded_pipeline_fn",
              raised is not None and "sharded_pipeline_fn" in raised, {"raised": raised})
    route2 = [n for n in CONFIGS if n not in HS_SINGLE_LEVEL]
    pair512 = [torch.as_tensor(im, device=dev)
               for im in particle_image_pair((512, 512), seed=0)[:2]]
    for size, names, p2 in ((512, route2, pair512), (shape[0], ROUTE2_AT_2048, pair)):
        sl = distributed.local_slices(m_r2, p2[0].shape, spec)
        t2 = [im[sl].contiguous() for im in p2]
        for name in names:
            fn2 = sharded_pipeline_fn(name, m_r2)
            (u, v), used = route2_counts(lambda: fn2(*t2))
            u, v = (distributed.gather_global(m_r2, t, spec) for t in (u, v))
            # the same run again (not counted), each kernel call held against
            # its plain version at this rank's own shapes; all ranks' records
            # to rank 0
            record = {}
            with kernels_against_plain(route2_swaps, record):
                fn2(*t2)
            torch.cuda.empty_cache()
            records = [None] * world
            torch.distributed.all_gather_object(records, record)
            t_r2 = timed(lambda: fn2(*t2), reps=3)
            if lead:
                ref = run_config(name, *p2)
                t_1 = timed(lambda: run_config(name, *p2), reps=3, together=False)
                e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
                launched = {k for k in route2_wrappers if used[f"{k}_launches"] > 0}
                check(f"sharded_pipeline_fn({name!r}) route 2 at {size}x{size} against "
                      f"run_config", e <= AEE_BAR and launched == expected_kernels(name),
                      {"route2": name, "size": size, "bitwise": same((u, v), ref), "aee": e,
                       "max_abs_diff": max_diff((u, v), ref),
                       "kernels": sorted(launched), "mesh": list(m_r2.shape),
                       "route2_ms": t_r2[0], "route2_host_ms": t_r2[1], "eager_ms": t_1[0],
                       "eager_host_ms": t_1[1], **used})
                report({"route2_plain": name, "size": size, "kernels": {
                    k: {"calls": sum(r.get(k, {}).get("calls", 0) for r in records),
                        "max_abs_diff": max(r.get(k, {}).get("max_abs_diff", 0.0)
                                            for r in records),
                        "signatures": sorted({sig for r in records
                                              for sig in r.get(k, {}).get("signatures", [])})}
                    for k in sorted(set().union(*records))},
                    "bar": "bitwise, every call of every rank"})
                del ref
            del u, v
        del t2
        torch.cuda.empty_cache()
    torch.distributed.barrier()

    # the biLinear=False (Liu-Shen) warp on tiles: the tile warp alone on
    # three flows, each rank's tile bit for bit the whole-image warp cropped;
    # its time at 2048^2 beside the whole-image warp's; then the two-level
    # biLinear=False pyramids (LS_WARP_PYRAMIDS) under kernel_sharded_solvers,
    # every kernel count zeroed just before each run and read just after,
    # against the single-device driver, and the same run again inside
    # kernels_against_plain (K1, K4/K5)
    from opticalflow_ri_tpu_torch.ops.warp import liu_shen_warp
    from opticalflow_ri_tpu_torch.parallel.sharded_glue import liu_shen_warp_sharded

    ls_meshes = [m_r2] if one else [m_r2, mesh((1, 4, 1))]
    ls_swaps = {k: route2_swaps[k] for k in ("hs_jacobi", "liu_shen")}
    for size, p2 in ((512, pair512), (shape[0], pair)):
        flows = warp_flows(p2[0].shape, dev)
        for m in ls_meshes:
            sl = distributed.local_slices(m, p2[0].shape, spec)
            for flow, (fu, fv) in flows.items():
                whole = liu_shen_warp(p2[0], fu, fv)
                got = liu_shen_warp_sharded(p2[0][sl].contiguous(), fu[sl].contiguous(),
                                            fv[sl].contiguous(), m)
                oks = [None] * world
                torch.distributed.all_gather_object(oks, bool(torch.equal(got, whole[sl])))
                check(f"liu_shen_warp_sharded, {flow} flow, {size}x{size} on {list(m.shape)}, "
                      f"against the whole-image warp cropped", all(oks),
                      {"ls_warp": flow, "size": size, "mesh": list(m.shape),
                       "bitwise_per_rank": oks})
                del whole, got
            if size == shape[0]:
                fu, fv = flows["crossing"]
                tf = [z[sl].contiguous() for z in (p2[0], fu, fv)]
                t_w = timed(lambda: liu_shen_warp_sharded(*tf, m), reps=5)
                if lead:
                    t_1 = timed(lambda: liu_shen_warp(p2[0], fu, fv), reps=5, together=False)
                    rec = {"ls_warp_times": "the crossing flow", "size": size,
                           "mesh": list(m.shape), "tile_ms": t_w[0], "tile_host_ms": t_w[1],
                           "whole_ms": t_1[0], "whole_host_ms": t_1[1]}
                    if one:   # device time: each captured in a CUDA graph, replayed
                        rec["tile_device_ms"] = graph_ms(lambda: liu_shen_warp_sharded(*tf, m))
                        rec["whole_device_ms"] = graph_ms(lambda: liu_shen_warp(p2[0], fu, fv))
                    report(rec)
                del tf
        del flows
        torch.cuda.empty_cache()
        for m in ls_meshes:
            sl = distributed.local_slices(m, p2[0].shape, spec)
            t2 = [im[sl].contiguous() for im in p2]
            for name in LS_WARP_PYRAMIDS:
                run = ls_warp_pyramid(name, m)
                (u, v), used = route2_counts(lambda: run(*t2))
                u, v = (distributed.gather_global(m, t, spec) for t in (u, v))
                record = {}
                with kernels_against_plain(ls_swaps, record):
                    run(*t2)
                records = [None] * world
                torch.distributed.all_gather_object(records, record)
                t_e = timed(lambda: run(*t2), reps=3)
                if lead:
                    single = ls_warp_pyramid(name, None)
                    ref = single(*p2)
                    t_1 = timed(lambda: single(*p2), reps=3, together=False)
                    e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
                    launched = {k for k in route2_wrappers if used[f"{k}_launches"] > 0}
                    plain = {k: {"calls": sum(r.get(k, {}).get("calls", 0) for r in records),
                                 "max_abs_diff": max(r.get(k, {}).get("max_abs_diff", 0.0)
                                                     for r in records)} for k in ls_swaps}
                    bitwise = same((u, v), ref)
                    check(f"biLinear=False pyramid ({name}) on {list(m.shape)} at {size}x{size} "
                          f"against the single-device driver",
                          (bitwise if one else e <= AEE_BAR)
                          and launched == {LS_WARP_KERNELS[name]},
                          {"ls_warp_pyramid": name, "size": size, "mesh": list(m.shape),
                           "bitwise": bitwise, "aee": e, "max_abs_diff": max_diff((u, v), ref),
                           "kernels": sorted(launched), "plain": plain,
                           "sharded_ms": t_e[0], "sharded_host_ms": t_e[1],
                           "single_ms": t_1[0], "single_host_ms": t_1[1], **used})
                    del ref
                del u, v
            del t2
            torch.cuda.empty_cache()
    torch.distributed.barrier()

    if one:
        # the sharded pipeline as one CUDA graph per tile shape
        # (auto_sharded_pipeline, _force_sharded on the one rank): every
        # configuration at 512^2 (route 1 and route 2) and route 2's 2048^2
        # set with HS_Fs3_4, each replay bit for bit against the eager
        # sharded call and run_config; the kernels counted during the
        # capture alone (the eager warm-up runs first, uncounted; a replay
        # counts nothing; a capture would raise at a host read of a
        # tensor); event ms of the replay, the eager sharded call and
        # compiled_pipeline's replay in turns
        from opticalflow_ri_tpu_torch.compile import compiled_pipeline

        def turns(calls: dict, reps: int = 10) -> dict:
            ev, host = {k: [] for k in calls}, {k: [] for k in calls}
            for _ in range(reps):
                for k, call in calls.items():
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    call()
                    host[k].append(1e3 * (time.perf_counter() - t0))
                    end.record()
                    end.synchronize()
                    ev[k].append(start.elapsed_time(end))
            return {k: (statistics.median(ev[k]), statistics.median(host[k])) for k in calls}

        for size, names, p2 in ((512, list(CONFIGS), pair512),
                                (shape[0], ["HS_Fs3_4", *ROUTE2_AT_2048], pair)):
            for name in names:
                graph = auto_sharded_pipeline(name, m_r2, _force_sharded=True)
                eager = sharded_pipeline_fn(name, m_r2)
                single = compiled_pipeline(name)
                t0 = time.perf_counter()
                graph.warm_up(*p2)
                got, captured = route2_counts(lambda: graph(*p2))
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
                want = eager(*p2)
                ref = run_config(name, *p2)
                again, replayed = route2_counts(lambda: graph(*p2))
                single(*p2)   # its capture, before the turns
                t = turns({"replay": lambda: graph(*p2), "eager": lambda: eager(*p2),
                           "single_replay": lambda: single(*p2)})
                rec = {"graph_sharded": name, "size": size,
                       "route": 1 if name in HS_SINGLE_LEVEL else 2,
                       "bitwise_eager": same(got, want) and same(again, want),
                       "bitwise_run_config": same(got, ref),
                       "max_abs_diff_run_config": max_diff(got, ref),
                       "capture": {k: c for k, c in captured.items() if c},
                       "replay_launches": sum(replayed[f"{k}_launches"]
                                              for k in route2_wrappers),
                       "warm_up_and_capture_s": capture_s,
                       "replay_ms": t["replay"][0], "replay_host_ms": t["replay"][1],
                       "eager_sharded_ms": t["eager"][0], "eager_sharded_host_ms": t["eager"][1],
                       "single_replay_ms": t["single_replay"][0],
                       "single_replay_host_ms": t["single_replay"][1], "reps": 10}
                check(f"auto_sharded_pipeline({name!r}) replayed at {size}x{size} against "
                      f"sharded_pipeline_fn and run_config", rec["bitwise_eager"]
                      and rec["bitwise_run_config"] and rec["replay_launches"] == 0, rec)
                graph.release()
                single.release()
                del got, want, ref, again, graph
            torch.cuda.empty_cache()

        # the biLinear=False pyramids as one CUDA graph per tile shape
        # (compile.CompiledPipeline over the run on tiles), bit for bit
        # against the eager sharded call and the single-device driver, the
        # kernels counted during the capture alone; the replay, the eager
        # sharded call and the single-device run's replay timed in turns
        from opticalflow_ri_tpu_torch.compile import CompiledPipeline

        for size, p2 in ((512, pair512), (shape[0], pair)):
            for name in LS_WARP_PYRAMIDS:
                eager = ls_warp_pyramid(name, m_r2)
                graph = CompiledPipeline(f"biLinear=False {name}, sharded", eager)
                single = CompiledPipeline(f"biLinear=False {name}",
                                          ls_warp_pyramid(name, None))
                t0 = time.perf_counter()
                graph.warm_up(*p2)
                got, captured = route2_counts(lambda: graph(*p2))
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
                want = eager(*p2)
                ref = ls_warp_pyramid(name, None)(*p2)
                again, replayed = route2_counts(lambda: graph(*p2))
                single(*p2)   # its capture, before the turns
                t = turns({"replay": lambda: graph(*p2), "eager": lambda: eager(*p2),
                           "single_replay": lambda: single(*p2)})
                rec = {"ls_warp_graph": name, "size": size,
                       "bitwise_eager": same(got, want) and same(again, want),
                       "bitwise_single": same(got, ref),
                       "max_abs_diff_single": max_diff(got, ref),
                       "capture": {k: c for k, c in captured.items() if c},
                       "replay_launches": sum(replayed[f"{k}_launches"]
                                              for k in route2_wrappers),
                       "warm_up_and_capture_s": capture_s,
                       "replay_ms": t["replay"][0], "replay_host_ms": t["replay"][1],
                       "eager_sharded_ms": t["eager"][0], "eager_sharded_host_ms": t["eager"][1],
                       "single_replay_ms": t["single_replay"][0],
                       "single_replay_host_ms": t["single_replay"][1], "reps": 10}
                check(f"the biLinear=False pyramid ({name}) replayed at {size}x{size} against "
                      f"the eager sharded call and the single-device driver",
                      rec["bitwise_eager"] and rec["bitwise_single"]
                      and rec["replay_launches"] == 0
                      and captured[f"{LS_WARP_KERNELS[name]}_launches"] > 0, rec)
                graph.release()
                single.release()
                del got, want, ref, again, graph
            torch.cuda.empty_cache()

    if not one:
        # the batch-sharded scan: 16 pairs at 512^2 over four ranks
        m_s = mesh((4, 1, 1))
        stacks = [particle_image_pair(shape=(512, 512), seed=s)[:2] for s in range(16)]
        s1, s2 = (torch.as_tensor(np.stack([p[i] for p in stacks]), device=dev) for i in (0, 1))
        take = batch_sharding(m_s)
        scan = batch_sharded_scan("HS_Fs3_4", m_s)
        us, vs = scan(take(s1), take(s2))
        us, vs = (distributed.gather_global(m_s, t, ("batch", None, None)) for t in (us, vs))
        if lead:
            ref = scan_pipeline("HS_Fs3_4")(s1, s2)
            check("batch_sharded_scan('HS_Fs3_4'), 16 pairs at 512x512", same((us, vs), ref),
                  {"bitwise": same((us, vs), ref), "mesh": list(m_s.shape)})
        # the runner on the campaign's pairs: a run, then a resume
        from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner

        with open(os.path.join(work, "pairs.json")) as f:
            pairs = [tuple(p) for p in json.load(f)]
        out = os.path.join(work, "out_mesh")
        first = FlowBatchRunner("HS_Fs3_4", batch_size=8, output_dir=out, mesh=m_s).run(pairs[:16])
        state = FlowBatchRunner("HS_Fs3_4", batch_size=8, output_dir=out, mesh=m_s).run(pairs)
        report({"runner": "FlowBatchRunner(mesh=(4, 1, 1)), batch 8",
                "first_done": sorted(first["done"]), "done": sorted(state["done"]),
                "failed": sorted(state["failed"])})
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def run_group(world: int, backend: str, work: str) -> list:
    """Spawn ``world`` ranks of ``rank_main`` on the one GPU and wait for all;
    returns rank 0's output lines.  A rank that fails, or a group that
    outlasts ``PARALLEL_TIMEOUT_S``, stops every rank and raises."""
    rdv_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(rdv_dir, exist_ok=True)
    rdv = os.path.join(rdv_dir, f"rendezvous_{backend}_{world}_{os.getpid()}")
    if os.path.exists(rdv):
        os.remove(rdv)
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    # each rank's output to files, read once the group has ended: a pipe that
    # nobody reads would stop a rank that writes more than it holds
    logs = [tuple(os.path.join(work, f"rank{r}_{backend}{world}.{k}") for k in ("out", "err"))
            for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r][0], "w") as out, open(logs[r][1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
                     str(world), backend, f"file://{rdv}", work],
                    stdout=out, stderr=err, env=env, cwd=ROOT))
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if os.path.exists(rdv):
            os.remove(rdv)
    outs = []
    for paths in logs:
        texts = []
        for path in paths:
            with open(path) as f:
                texts.append(f.read())
        outs.append(texts)
    lines = outs[0][0].splitlines()
    for line in lines:
        print(f"  [{backend} x{world}] {line}", flush=True)
    codes = [p.returncode for p in procs]
    if any(codes):
        for r, (_, err) in enumerate(outs):
            print(f"  [{backend} x{world} rank {r}] exit {codes[r]}; stderr tail:\n"
                  + "\n".join(err.splitlines()[-25:]), flush=True)
        raise AssertionError(f"the {backend} group of {world} ranks failed: exit codes {codes}")
    return lines


def main() -> None:
    import torch

    # ---------------------------------------------------------------- 1
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    if not os.path.isdir(PKG):
        raise SystemExit(f"chip_smoke: {PKG} not found; run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    from opticalflow_ri_tpu_torch import (
        FarnebackAdapter, GenericPyramidalOpticalFlowWrapper, HSOpticalFlowAlgoAdapter,
        LiuShenOpticalFlowAlgoAdapter, generic_pyramidal_optical_flow,
    )
    from opticalflow_ri_tpu_torch.configs import CONFIGS, run_config
    from opticalflow_ri_tpu_torch.models import liu_shen as ls_model
    from opticalflow_ri_tpu_torch.parallel.auto import HS_SINGLE_LEVEL
    from opticalflow_ri_tpu_torch.models.farneback import (
        _level_plan, _window_blur_spec, farneback_solve, gaussian_blur, poly_expansion,
    )
    from opticalflow_ri_tpu_torch.models.liu_shen import (
        liu_shen_iteration, liu_shen_precompute, liu_shen_solve,
    )
    from opticalflow_ri_tpu_torch.models.lucas_kanade import (
        DenseLucasKanadeAdapter, lk_dense_solve, lk_kernel_inputs,
    )
    from opticalflow_ri_tpu_torch.ops.cuda import (
        build, fb_fused, hs_iter, liu_shen_iter, lk_build, lk_iter, poly_expand, tent_sample,
        warp_tent,
    )
    from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow as fb_blur
    from opticalflow_ri_tpu_torch.ops.padding import pad2d
    from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    assert "jax" not in sys.modules, "the port imported jax"
    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    print(f"gpu: {gpu}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  timeout=60, check=True).stdout.strip().splitlines()
    print(f"nvcc {nvcc}: {nvcc_version[-1]}")

    # ---------------------------------------------------------------- 2
    phase("build")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  {line.strip()}")

    # ---------------------------------------------------------------- 3
    phase("parity")
    rng = np.random.default_rng(0)

    def rand(shape, lo, hi):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    err = {"hs_jacobi": 0.0, "warp_pair": 0.0, "liu_shen": 0.0, "lk_build": 0.0,
           "lk_gn": 0.0, "lk_fused": 0.0, "fb_poly_expand": 0.0, "fb_update_matrices": 0.0,
           "fb_blur5_flow": 0.0, "fb_fused": 0.0}
    # the HS kernel runs STEPS_PER_LAUNCH iterations a launch: every count
    # around that depth, 100 and 600 as the configs run them
    steps = hs_iter.STEPS_PER_LAUNCH
    for shape in [(2, 2), (3, 517), (333, 517), (512, 512), (2048, 2048)]:
        fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
        u0, v0 = rand(shape, -2, 2), rand(shape, -2, 2)
        for niter in (0, 1, steps - 1, steps, steps + 1, 100, 600):
            got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, niter)
            want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, niter)
            torch.cuda.synchronize()
            d = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"hs_jacobi {shape} niter={niter} ({len(hs_iter.launch_plan(niter, steps))} "
                  f"launches): max|d|={d!r} (bar: bitwise) bitwise={same}")
            if not same:
                raise AssertionError(f"hs_jacobi disagrees with its plain version at {shape}")
            err["hs_jacobi"] = max(err["hs_jacobi"], d)
    for shape in [(512, 512), (333, 517)]:
        for label, dmax in (("calibrated", 4.0), ("wild", 20.0)):
            args = [rand(shape, 0, 255), rand(shape, 0, 255)]
            args += [rand(shape, -dmax, dmax) for _ in range(4)]
            got = warp_tent.warp_pair(*args)
            want = warp_tent.warp_pair_plain(*args)
            torch.cuda.synchronize()
            d = max(float((g - w).abs().max()) for g, w in zip(got, want))
            bar = WARP_BAR_REL * 255.0
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"warp_pair {shape} {label} |d|<={dmax}: max|d|={d!r} (bar {bar}) "
                  f"bitwise={same}")
            if not d <= bar:
                raise AssertionError(f"warp_pair disagrees with its plain version at {shape}")
            err["warp_pair"] = max(err["warp_pair"], d)

    def ls_fields(shape, h=10.0):
        a, b = rand(shape, 1, 255), rand(shape, 1, 255)
        return liu_shen_precompute(a / a.max(), b / b.max(), h)

    def stop_tol(fields, u0, v0, residue, steps, h=10.0, max_iter=60):
        """(k, tol): a tol that stops the plain solve after k < max_iter
        steps, k = residue mod ``steps``, the errs of steps k-1 and k each at
        least 0.1% away from it."""
        errs, u, v = [], u0, v0
        for _ in range(max_iter):
            un, vn = liu_shen_iteration(u, v, fields, h)
            errs.append(float((torch.linalg.norm(un - u) + torch.linalg.norm(vn - v))
                              / float(u.numel())))
            u, v = un, vn
        for k in range(2, max_iter):
            tol = float(np.sqrt(errs[k - 2] * errs[k - 1]))
            if (k % steps == residue and errs[k - 1] < 0.999 * tol
                    and min(errs[:k - 1]) > 1.001 * tol):
                return k, tol
        raise AssertionError(f"no tol stops at k = {residue} mod {steps} in {errs}")

    # the Liu-Shen kernel runs T steps a launch: counts around that depth,
    # 60 as the configs run it, and stops at the last, the first and the
    # next-to-last step of a launch (the last two replayed)
    ls_steps = liu_shen_iter.STEPS_PER_LAUNCH
    shapes = [(2, 2), (3, 517), (47, 61), (333, 517), (512, 512), (2048, 2048)]
    gated_err = 0.0
    for shape in shapes:
        fields = ls_fields(shape)
        u0, v0 = rand(shape, -0.5, 0.5), rand(shape, -0.5, 0.5)
        cases = [(f"fixed {n}", n, 0.0, n) for n in (0, 1, ls_steps, ls_steps + 1, 60)]
        for residue in (0, 1, ls_steps - 1):
            k_want, tol = stop_tol(fields, u0, v0, residue, ls_steps)
            cases.append((f"stop at k={k_want} (mod T: {residue})", 60, tol, k_want))
        for label, max_iter, tol, k_want in cases:
            got = liu_shen_iter.liu_shen_iterate(10.0, fields, u0, v0, max_iter, tol)
            want = liu_shen_iter.liu_shen_iterate_plain(10.0, fields, u0, v0, max_iter, tol)
            torch.cuda.synchronize()
            d = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
            same = all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
            kg, kw = int(got[3]), int(want[3])
            eg, ew = float(got[2]), float(want[2])
            e_rel = abs(eg - ew) / ew if ew else abs(eg)
            print(f"liu_shen {shape} {label} max_iter={max_iter} tol={tol!r} (T={ls_steps}): "
                  f"max|d|={d!r} (bar: bitwise) bitwise={same} k={kg} plain k={kw} "
                  f"err={eg!r} plain err={ew!r} (rel {e_rel!r}, bar {LS_ERR_BAR})")
            if kw != k_want:
                raise AssertionError(f"liu_shen plain stopped at {kw}, expected {k_want}")
            if not (kg == kw and same and e_rel <= LS_ERR_BAR):
                raise AssertionError(f"liu_shen disagrees with its plain version at {shape}")
            err["liu_shen"] = max(err["liu_shen"], d)
        # the device gate of the sharded solve's stop: 0 runs no step and
        # returns (u0, v0, 0, 0), 1 the call without a gate; with and
        # without the stop, the whole image and an apron mask
        for gate in (0, 1):
            g = torch.tensor(gate, dtype=torch.int32, device=dev)
            for stop, edges, tol in ((True, hs_iter.ALL, 1e-7), (False, hs_iter.ALL, 0.0),
                                     (False, 0, 0.0)):
                args = (10.0, fields, u0, v0, 60, tol, edges, stop)
                got = liu_shen_iter.liu_shen_iterate(*args, gate=g)
                want = liu_shen_iter.liu_shen_iterate_plain(*args, gate=g)
                torch.cuda.synchronize()
                d = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
                same = (all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
                        and int(got[3]) == int(want[3]))
                if gate == 0:
                    same = (same and torch.equal(got[0], u0) and torch.equal(got[1], v0)
                            and int(got[3]) == 0 and float(got[2]) == 0.0)
                print(f"liu_shen {shape} gate={gate} stop={stop} edges={edges}: max|d|={d!r} "
                      f"(bar: bitwise, k equal) bitwise={same} k={int(got[3])}")
                if not same:
                    raise AssertionError(f"gated liu_shen disagrees with its plain version at "
                                         f"{shape}")
                gated_err = max(gated_err, d)
        del fields
        torch.cuda.empty_cache()

    def lk_pair(shape):
        """A random frame and its rolled, noisy copy, on the card."""
        a = rng.uniform(0, 255, shape).astype(np.float32)
        b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
        return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)

    def lk_problem(pair, dmax=4.0, asym=(0, 0, 0, 0)):
        """The LK kernels' inputs (half window 13, R = 5: 121 shifts) for a
        pair and a random initial flow of |d| <= dmax."""
        shape = tuple(pair[0].shape)
        return lk_kernel_inputs(*pair, rand(shape, -dmax, dmax), rand(shape, -dmax, dmax),
                                asym=asym)

    def lk_compare(name, label, got, want):
        """px, py and status bit for bit."""
        d = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"{name} {label}: max|d|={d!r} (bar: bitwise, status too) bitwise={same}")
        if not same:
            raise AssertionError(f"{name} disagrees with its plain version ({label})")
        err[name] = max(err[name], d)

    def lk_stops_input(shape):
        """GN inputs whose pixels end their loop at every step from 0 to 5: a
        frame with a flat band (singular windows: no step) and its rolled
        noisy copy, some origins beyond the bail bounds (a bail at the first
        step), the rest a random flow of |d| <= 4; the planes from the build
        kernel, which the parity above holds to its plain version."""
        a = rng.uniform(0, 255, shape).astype(np.float32)
        a[:, : shape[1] // 4] = 7.0
        b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
        u0 = rng.uniform(-4, 4, shape).astype(np.float32)
        v0 = rng.uniform(-4, 4, shape).astype(np.float32)
        u0[::3, ::2] = 70.0
        v0[1::4, 1::3] = -60.0
        slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
            *(torch.as_tensor(x, device=dev) for x in (a, b, u0, v0)))
        return (*lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x), *fields)

    gn_exits = set()

    # the LK build's windows: symmetric, asymmetric (near and far taps
    # dropped in x: two runs), and four runs of every ladder form
    lk_windows = {"symmetric": None, "asym (1, 0, 0, 1)": (1, 0, 0, 1),
                  "four runs": (((0, 3), (5, 10), (12, 26), (28, 31)),
                                ((0, 26), (27, 27), (28, 29), (30, 31)))}
    for shape in [(512, 512), (333, 517), (2048, 2048)]:
        pair = lk_pair(shape)
        for wname, window in lk_windows.items():
            if wname == "four runs" and shape != (512, 512):
                continue
            asym = window if wname.startswith("asym") else (0, 0, 0, 0)
            slab, g_pair, _, runs_y, runs_x = lk_problem(pair, asym=asym)
            if wname == "four runs":
                runs_y, runs_x = window
            got = lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)
            want = lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x)
            torch.cuda.synchronize()
            d = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"lk_build {shape} {wname} window {runs_y} x {runs_x}, 2x121 planes: "
                  f"max|d|={d!r} (bar: bitwise) bitwise={same}")
            if not same:
                raise AssertionError(f"lk_build disagrees with its plain version at {shape}")
            err["lk_build"] = max(err["lk_build"], d)
            if wname == "symmetric":  # the GN and fused kernels take these
                sym = (slab, g_pair, runs_y, runs_x, got)
            del got, want
            torch.cuda.empty_cache()
        slab, g_pair, runs_y, runs_x, (t1, t2) = sym
        del sym
        im_a, im_b, _, _ = particle_image_pair(shape=shape, seed=0)
        cfg_gn = capture_lk_args(run_config, lk_build, lk_iter, "LK_Fs2_0",
                                 torch.as_tensor(im_a, device=dev),
                                 torch.as_tensor(im_b, device=dev))[1]
        gn_inputs = {"calibrated |d|<=4": (t1, t2, *lk_problem(pair, 4.0)[2]),
                     "wild |d|<=20": (t1, t2, *lk_problem(pair, 20.0)[2]),
                     "configs' own (LK_Fs2_0)": cfg_gn[:10],
                     "stops (flat band, bails)": lk_stops_input(shape)}
        for label, gargs in gn_inputs.items():
            counts = gn_exit(lk_iter, *gargs, 5, 5, 13)[3]
            hist = torch.bincount(counts.flatten(), minlength=6).tolist()
            gn_exits.update(k for k, c in enumerate(hist) if c)
            for n_iter in (0, 1, 5):
                got = lk_iter.lk_gn_iterate(*gargs, n_iter, 5, 13)
                want = lk_iter.lk_gn_iterate_plain(*gargs, n_iter, 5, 13)
                torch.cuda.synchronize()
                lk_compare("lk_gn", f"{shape} {label} n_iter={n_iter} "
                           f"(pixels by steps run 0..5: {hist})", got, want)
        del t1, t2, got, want, gn_inputs, cfg_gn
        torch.cuda.empty_cache()
    if gn_exits != set(range(6)):
        raise AssertionError(f"the GN parity inputs end pixels at steps {sorted(gn_exits)}, "
                             f"not at every step from 0 to 5")

    # the fused LK solve: from a partial last tile up to 2048^2, the three
    # windows, R = 5 (clusters of 8) and, at 512^2, R = 6 (clusters of 16)
    for shape in [(47, 61), (333, 517), (512, 512), (2048, 2048)]:
        pair = lk_pair(shape)
        cases = [(wname, window, 5) for wname, window in lk_windows.items()]
        if shape == (512, 512):
            cases.append(("symmetric", None, 6))
        for wname, window, R in cases:
            asym = window if wname.startswith("asym") else (0, 0, 0, 0)
            slab, g_pair, fields, runs_y, runs_x = lk_kernel_inputs(
                *pair, rand(shape, -20, 20), rand(shape, -20, 20), asym=asym, max_shift=R)
            if wname == "four runs":
                runs_y, runs_x = window
            got = lk_iter.lk_fused(slab, g_pair, *fields, 5, R, 13, runs_y, runs_x)
            want = lk_iter.lk_fused_plain(slab, g_pair, *fields, 5, R, 13, runs_y, runs_x)
            torch.cuda.synchronize()
            lk_compare("lk_fused", f"{shape} {wname} window {runs_y} x {runs_x}, R={R} "
                       f"(cluster of {lk_iter.fused_plan(R)[0]}), n_iter=5 wild |d|<=20",
                       got, want)
            del slab, g_pair, fields, got, want
            torch.cuda.empty_cache()

    windows = {"gaussian": _window_blur_spec(33, True), "box": _window_blur_spec(33, False)}

    def fb_expansions(shape, seed=0):
        """R0, R1 (polyN 7, sigma 1.5) of a particle pair, on the card: PIV-like,
        so the 2x2 solve is well conditioned."""
        a, b, _, _ = particle_image_pair(shape=shape, seed=seed)
        return [poly_expansion(torch.as_tensor(im, device=dev), 7, 1.5).contiguous()
                for im in (a, b)]

    def fb_compare(name, label, got, want, bar):
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"{name} {label}: max|d|={d!r} (bar {bar!r}) bitwise={same}")
        if not d <= bar:
            raise AssertionError(f"{name} disagrees with its plain version ({label})")
        err[name] = max(err[name], d)

    # the expansion, bit for bit: the whole-image source (the replicate
    # rule's rows) at the pyramid's sizes and a partial last tile, and at
    # 2048^2 an interior stripe whose aprons are its neighbours' rows
    for shape in [(512, 512), (1024, 1024), (2048, 2048), (333, 517)]:
        im = torch.as_tensor(particle_image_pair(shape=shape, seed=0)[0], device=dev)
        for n, sigma in ((7, 1.5), (5, 1.1)):
            cases = [("whole image", pad2d(im, ((n, n), (0, 0)), "nearest"))]
            if shape == (2048, 2048):
                cases.append(("stripe rows 512-1023", im[512 - n:1024 + n]))
            for label, srcp in cases:
                got = poly_expand.poly_expand(srcp, n, sigma)
                want = poly_expand.poly_expand_plain(srcp, n, sigma)
                torch.cuda.synchronize()
                fb_compare("fb_poly_expand", f"{shape} {label} polyN {n} sigma {sigma}",
                           [got], [want], 0.0)
                if not torch.equal(got, want):
                    raise AssertionError(f"fb_poly_expand disagrees with its plain version at "
                                         f"{shape}, {label}, polyN {n}")
        del im, srcp, got, want
        torch.cuda.empty_cache()

    for shape in [(512, 512), (333, 517), (2048, 2048)]:
        r0, r1 = fb_expansions(shape)
        cases = [("calibrated", 4.0, 5), ("wild", 20.0, 5)]
        if shape == (512, 512):
            cases.append(("calibrated", 4.0, None))
        for label, dmax, R in cases:
            fx, fy = rand(shape, -dmax, dmax), rand(shape, -dmax, dmax)
            got = tent_sample.update_matrices(fx, fy, r0, r1, R)
            want = tent_sample.update_matrices_plain(fx, fy, r0, r1, R)
            torch.cuda.synchronize()
            fb_compare("fb_update_matrices", f"{shape} R={R} {label} |d|<={dmax}", [got], [want],
                       FB_M_BAR * float(want.abs().max()))
        del r0, r1, got, want
        torch.cuda.empty_cache()

    # the blur + solve: every tap count the kernel's register blocking treats
    # apart, the Gaussian ("mirror"), the box ("nearest", scale 1/n^2) and a
    # post-scaled Gaussian, on the M of a particle pair at zero flow
    for shape in shapes:
        big = (max(shape[0], 16), max(shape[1], 16))
        r0, r1 = (r[:, :shape[0], :shape[1]].contiguous() for r in fb_expansions(big))
        z = torch.zeros(shape, dtype=torch.float32, device=dev)
        m = tent_sample.update_matrices_plain(z, z, r0, r1)
        for n in (1, 3, 33, 129):
            for wname in ("gaussian", "box", "gaussian-scaled"):
                taps, mode, scale = _window_blur_spec(n, wname != "box")
                scale = 0.37 if wname == "gaussian-scaled" else scale
                got = fb_blur.blur5_flow(m, taps, mode, scale)
                want = fb_blur.blur5_flow_plain(m, taps, mode, scale)
                torch.cuda.synchronize()
                d = max(float((g - w).abs().max()) for g, w in zip(got, want))
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"fb_blur5_flow {shape} {wname} {n} taps ({mode}, scale {scale!r}): "
                      f"max|d|={d!r} (bar: bitwise) bitwise={same}")
                if not same:
                    raise AssertionError(f"fb_blur5_flow disagrees with its plain version "
                                         f"at {shape}, {n} taps, {wname}")
                err["fb_blur5_flow"] = max(err["fb_blur5_flow"], d)
        del r0, r1, m, got, want
        torch.cuda.empty_cache()

    # the fused loop, bit for bit: every round count at the calibrated 33
    # taps, the tap counts the tile blur treats apart, the exact gather; the
    # blocks walk several tiles each from 333x517 up
    for shape in shapes:
        big = (max(shape[0], 16), max(shape[1], 16))
        r0, r1 = (r[:, :shape[0], :shape[1]].contiguous() for r in fb_expansions(big))
        fx0, fy0 = rand(shape, -1, 1), rand(shape, -1, 1)
        cases = [(wname, 33, n_iters, 5) for n_iters in (0, 1, 2, 5)
                 for wname in ("gaussian", "box", "gaussian-scaled")]
        cases += [(wname, n, 2, 5) for n in (1, 3, 129)
                  for wname in ("gaussian", "box", "gaussian-scaled")]
        cases += [("gaussian", 33, n_iters, None) for n_iters in (1, 5)]
        for wname, n, n_iters, R in cases:
            taps, mode, scale = _window_blur_spec(n, wname != "box")
            scale = 0.37 if wname == "gaussian-scaled" else scale
            got = fb_fused.fb_fused(r0, r1, fx0, fy0, n_iters, taps, mode, scale, R)
            want = fb_fused.fb_fused_plain(r0, r1, fx0, fy0, n_iters, taps, mode, scale, R)
            torch.cuda.synchronize()
            d = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"fb_fused {shape} {wname} {n} taps ({mode}, scale {scale!r}) n_iters={n_iters} "
                  f"R={R}: max|d|={d!r} (bar: bitwise) bitwise={same}")
            if not same:
                raise AssertionError(f"fb_fused disagrees with its plain version at {shape}, "
                                     f"{n} taps, {wname}, n_iters={n_iters}, R={R}")
            err["fb_fused"] = max(err["fb_fused"], d)
        del r0, r1, got, want
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4
    phase("main")
    im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)
    g1, g2 = torch.as_tensor(im1, device=dev), torch.as_tensor(im2, device=dev)
    c1, c2 = torch.as_tensor(im1), torch.as_tensor(im2)

    def wrapper(a, b):
        return GenericPyramidalOpticalFlowWrapper(
            HSOpticalFlowAlgoAdapter([21.0], 600), filter_sigma=3.4).calculateFlow(a, b)

    runs = {name: (lambda a, b, n=name: run_config(n, a, b))
            for name in ("HS_Fs0_0", "HS_Fs3_4", "PyHSchunck_Fs3_4", "HS_Fs3_4_PyrLvls2",
                         "PyHSchunck_Fs3_4_PyrLvls2")}
    runs["Wrapper_HS_21_600_Fs3_4"] = wrapper
    for name in ("LiuSE_HS_Fs3_4_PyrLvls2", "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
                 "LiuSE_LK_Fs2_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2") + LK_CONFIGS + FB_CONFIGS:
        runs[name] = lambda a, b, n=name: run_config(n, a, b)

    def fused_solve(a, b):
        """The fused LK kernel's entry point: one calibrated LK solve from zero flow."""
        z = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        return lk_dense_solve(a, b, z, z, impl="fused")[:2]

    runs["lk_dense_solve_fused"] = fused_solve

    def fb_fused_solve(a, b):
        """The fused Farneback kernel's entry point: the calibrated iteration
        loop (window 33 Gaussian, 5 iterations, polyN 7, polySigma 1.5) from
        zero flow on the level-0 expansions, i.e. ``farneback_solve`` at one
        level."""
        lvl = _level_plan(a.shape[0], a.shape[1], 0.5, 0)[0]
        r0, r1 = (poly_expansion(gaussian_blur(im.float(), lvl["smooth"], lvl["sigma"]), 7, 1.5)
                  .contiguous() for im in (a, b))
        z = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        taps, mode, scale = windows["gaussian"]
        return fb_fused.fb_fused(r0, r1, z, z, 5, taps, mode, scale)

    runs["fb_fused_solve"] = fb_fused_solve

    wrappers = {"hs_jacobi": hs_iter.hs_iterate, "warp_pair": warp_tent.warp_pair,
                "liu_shen": liu_shen_iter.liu_shen_iterate,
                "lk_build": lk_build.lk_build_planes, "lk_gn": lk_iter.lk_gn_iterate,
                "lk_fused": lk_iter.lk_fused, "fb_poly_expand": poly_expand.poly_expand,
                "fb_update_matrices": tent_sample.update_matrices,
                "fb_blur5_flow": fb_blur.blur5_flow, "fb_fused": fb_fused.fb_fused}

    expected = expected_kernels

    # each Liu-Shen call's k: the solver's handle on the kernel module is
    # swapped, for the main-path runs only, for one whose wrapper keeps k (a
    # device tensor, no sync); the wrapper and its count are the kernel's own
    ls_k = []

    def ls_recording(*args):
        out = liu_shen_iter.liu_shen_iterate(*args)
        ls_k.append((out[3], args[4]))
        return out

    for fn in wrappers.values():
        fn.launches = 0
    flows, counts, ls_ks = {}, {}, {}
    ls_model.liu_shen_iter = types.SimpleNamespace(liu_shen_iterate=ls_recording)
    try:
        for name, fn in runs.items():
            before = {k: w.launches for k, w in wrappers.items()}
            del ls_k[:]
            flows[name] = fn(g1, g2)
            counts[name] = {k: w.launches - before[k] for k, w in wrappers.items()}
            ls_ks[name] = list(ls_k)
    finally:
        ls_model.liu_shen_iter = liu_shen_iter
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"main-path launches: {launches}")
    for name, calls in ls_ks.items():
        if calls:
            print(f"{name}: Liu-Shen k per call (of max_iter) "
                  f"{[f'{int(k)}/{m}' for k, m in calls]}")

    for name, (u, v) in flows.items():
        if u.device != dev or u.shape != (512, 512) or u.dtype != torch.float32:
            raise AssertionError(f"{name}: flow {u.dtype} {tuple(u.shape)} on {u.device}")
        if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())):
            raise AssertionError(f"{name}: non-finite flow")
        launched = {k for k, c in counts[name].items() if c > 0}
        if launched != expected(name):
            raise AssertionError(f"{name}: launched {sorted(launched)}, expected "
                                 f"{sorted(expected(name))}")
        ref = runs[name](c1, c2)
        e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
        print(f"{name}: launches {counts[name]}, AEE vs CPU plain path {e!r} (bar {AEE_BAR})")
        if not e <= AEE_BAR:
            raise AssertionError(f"{name}: card and CPU disagree")

    z = torch.zeros((512, 512), dtype=torch.float32, device=dev)
    u, v = flows["fb_fused_solve"]
    ref = farneback_solve(g1, g2, z, z)
    e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
    same = torch.equal(u, ref[0]) and torch.equal(v, ref[1])
    print(f"fb_fused_solve against farneback_solve(pyr_levels=1) on the card: AEE {e!r} "
          f"(bar: bitwise, the same rounds) bitwise={same}")
    if not same:
        raise AssertionError("the fused Farneback loop disagrees with farneback_solve")

    golden = np.load(GOLDEN)
    s1, s2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    u, v = generic_pyramidal_optical_flow(
        s1, s2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1, device=dev)
    e = aee(to_np(u), to_np(v), golden["hs_u"], golden["hs_v"])
    print(f"golden 96x96 2-level HS on {u.device}: AEE {e!r} (bar {GOLDEN_BAR})")
    if not e < GOLDEN_BAR:
        raise AssertionError("golden flows disagree")
    u, v = generic_pyramidal_optical_flow(
        s1, s2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 60), 2, 1, FILTER_OPT=0.48,
        optionalOFlowAlgoAdapter=LiuShenOpticalFlowAlgoAdapter(5), device=dev)
    e = aee(to_np(u), to_np(v), golden["hs_ls_u"], golden["hs_ls_v"])
    print(f"golden 96x96 2-level HS + Liu-Shen(5) on {u.device}: AEE {e!r} (bar {GOLDEN_BAR})")
    if not e < GOLDEN_BAR:
        raise AssertionError("golden HS + Liu-Shen flows disagree")
    u, v = generic_pyramidal_optical_flow(
        s1, s2, 2.0, DenseLucasKanadeAdapter(), 2, 1, FILTER_OPT=0.48, warping=False,
        device=dev)
    bulk = float(((np.abs(to_np(u) - golden["lk_u"]) < 1e-2)
                  & (np.abs(to_np(v) - golden["lk_v"]) < 1e-2)).mean())
    print(f"golden 96x96 2-level LK on {u.device}: share of pixels within 1e-2 {bulk!r} "
          f"(bar > 0.99)")
    if not bulk > 0.99:
        raise AssertionError("golden LK flows disagree")
    u, v = generic_pyramidal_optical_flow(s1, s2, 0.0, FarnebackAdapter(), 2, 1, device=dev)
    e = aee(to_np(u), to_np(v), golden["fb_u"], golden["fb_v"])
    print(f"golden 96x96 2-level Farneback on {u.device}: AEE {e!r} (bar {FB_GOLDEN_BAR})")
    if not e < FB_GOLDEN_BAR:
        raise AssertionError("golden Farneback flows disagree")

    # ---------------------------------------------------------------- 5
    phase("times")

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    @contextlib.contextmanager
    def plain_kernels():
        """Route the main path through the plain versions, for the A/B only."""
        swaps = [(hs_iter, "hs_iterate"), (warp_tent, "warp_pair"),
                 (liu_shen_iter, "liu_shen_iterate"), (lk_build, "lk_build_planes"),
                 (lk_iter, "lk_gn_iterate"), (lk_iter, "lk_fused"),
                 (poly_expand, "poly_expand"), (tent_sample, "update_matrices"),
                 (fb_blur, "blur5_flow"), (fb_fused, "fb_fused")]
        saved = [getattr(mod, attr) for mod, attr in swaps]
        for mod, attr in swaps:
            setattr(mod, attr, getattr(mod, attr + "_plain"))
        try:
            yield
        finally:
            for (mod, attr), fn in zip(swaps, saved):
                setattr(mod, attr, fn)

    def ab(kernel_fn, plain_fn, reps=REPS):
        """Medians over ``reps`` turns, the order alternating each turn."""
        def run_plain():
            with plain_kernels():
                return event_ms(plain_fn)
        run_kernel = lambda: event_ms(kernel_fn)  # noqa: E731
        run_kernel(), run_plain()  # warm-up
        k, p = [], []
        for i in range(reps):
            if i % 2:
                p.append(run_plain()); k.append(run_kernel())
            else:
                k.append(run_kernel()); p.append(run_plain())
        return statistics.median(k), statistics.median(p)

    def device_ms(fn, replays: int) -> float:
        """The call captured once in a CUDA graph and replayed back to back:
        the device's time per call, without the host's enqueue."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        torch.cuda.empty_cache()
        return start.elapsed_time(end) / replays

    def grid_sample_pair(args, max_shift=8):
        """The library yardstick of the pair warp: one ``F.grid_sample`` call
        over both images as a batch of two (bilinear, border padding), its
        grid built beforehand from the clipped displacements."""
        import torch.nn.functional as F
        lo, hi = warp_tent._clip_bounds(max_shift)
        h, w = args[0].shape
        yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        ims = torch.stack(args[:2])[:, None]
        dys = torch.stack([args[2], args[4]]).clamp(lo, hi)
        dxs = torch.stack([args[3], args[5]]).clamp(lo, hi)
        grid = torch.stack([2 * (xx + dxs) / (w - 1) - 1, 2 * (yy + dys) / (h - 1) - 1], dim=-1)
        return lambda: F.grid_sample(ims, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

    saved_counts = dict(launches)
    config_times = {}
    for name, fn in runs.items():
        k, p = ab(lambda: fn(g1, g2), lambda: fn(g1, g2))
        config_times[name] = (k, p)
        print(json.dumps({"config": name, "shape": [512, 512], "kernel_ms": k, "plain_ms": p,
                          "gpu": gpu}))

    kernel_times, device_times, library_times, library_device_times = {}, {}, {}, {}

    bounds, gn_after_build, unfused_device = {}, {}, {}

    def time_kernel(name, shape, kernel_fn, plain_fn, reps, replays, key=None, gn=5, **info):
        """Event medians of kernel and plain in turns; the device time per
        call from graph replays (every kernel at 512^2, the redesigned HS,
        Liu-Shen and LK kernels and the FB expansion and blur at 2048^2 too);
        the bound of the call (``gn``: the mean GN steps a pixel runs on this
        input).
        Kept under ``key`` (default: the kernel's name)."""
        key = (key or name, shape)
        k, p = ab(kernel_fn, plain_fn, reps)
        kernel_times[key] = (k, p)
        rec = {"kernel": name, "shape": list(shape), **info, "kernel_ms": k, "plain_ms": p}
        if shape == (512, 512) or name in ("hs_jacobi", "liu_shen", "lk_build", "lk_gn",
                                           "lk_fused", "fb_poly_expand", "fb_blur5_flow",
                                           "fb_fused"):
            device_times[key] = rec["device_ms"] = device_ms(kernel_fn, replays)
        bounds[key] = bound_ms(*kernel_costs(*shape, gn_steps=gn)[name])
        rec["bound_ms"], rec["bound_by"] = bounds[key]
        print(json.dumps({**rec, "gpu": gpu}))

    for shape in [(512, 512), (2048, 2048)]:
        small = shape == (512, 512)
        reps = REPS if small else REPS_2048
        fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
        z = torch.zeros(shape, device=dev)
        time_kernel("hs_jacobi", shape, lambda: hs_iter.hs_iterate(fx, fy, ft, z, z, 1.0, 100),
                    lambda: hs_iter.hs_iterate_plain(fx, fy, ft, z, z, 1.0, 100), REPS, 20,
                    niter=100, steps_per_launch=hs_iter.STEPS_PER_LAUNCH)
        args = [rand(shape, 0, 255), rand(shape, 0, 255)]
        args += [rand(shape, -4, 4) for _ in range(4)]
        time_kernel("warp_pair", shape, lambda: warp_tent.warp_pair(*args),
                    lambda: warp_tent.warp_pair_plain(*args), REPS, 50, flow="|d|<=4")
        library = grid_sample_pair(args)
        lib_out = library()
        d_lib = max(float((lib_out[i, 0] - o).abs().max())
                    for i, o in enumerate(warp_tent.warp_pair(*args)))
        library_times[("warp_pair", shape)] = lib = statistics.median(
            event_ms(library) for _ in range(REPS))
        library_device_times[("warp_pair", shape)] = lib_dev = device_ms(library, 50)
        print(json.dumps({"library": "F.grid_sample, batch of 2", "yardstick_of": "warp_pair",
                          "shape": list(shape), "library_ms": lib, "library_device_ms": lib_dev,
                          "max_abs_diff_to_kernel": d_lib, "gpu": gpu}))
        del library, lib_out
        # the solve bench.py:328-338 times (h = 10, 60 iterations, tol = 0):
        # the whole solve, then the kernel alone on its precomputed fields
        a, b = rand(shape, 1, 255), rand(shape, 1, 255)
        k, p = ab(lambda: liu_shen_solve(a, b, 10.0, z, z, 60, 0.0),
                  lambda: liu_shen_solve(a, b, 10.0, z, z, 60, 0.0))
        print(json.dumps({"solve": "liu_shen_solve", "shape": list(shape), "h": 10.0,
                          "max_iter": 60, "tol": 0.0, "kernel_ms": k, "plain_ms": p,
                          "gpu": gpu}))
        fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
        time_kernel("liu_shen", shape,
                    lambda: liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, 0.0),
                    lambda: liu_shen_iter.liu_shen_iterate_plain(10.0, fields, z, z, 60, 0.0),
                    REPS, 20, h=10.0, max_iter=60, tol=0.0,
                    steps_per_launch=liu_shen_iter.STEPS_PER_LAUNCH)
        # the LK kernels at the calibrated config: half window 13, R = 5, 5 GN steps
        slab, g_pair, fields, runs_y, runs_x = lk_problem(lk_pair(shape))
        time_kernel("lk_build", shape,
                    lambda: lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x),
                    lambda: lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x),
                    reps, 10 if small else 3, shifts=121)
        # K7 and K8 on the configs' own input (what the wrappers receive in
        # one run_config("LK_Fs2_0") on the particle pair of this shape: a
        # smooth flow from zero), K7 also on the random flow above
        t1, t2 = lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)
        im_a, im_b, _, _ = particle_image_pair(shape=shape, seed=0)
        bargs, gargs = capture_lk_args(run_config, lk_build, lk_iter, "LK_Fs2_0",
                                       torch.as_tensor(im_a, device=dev),
                                       torch.as_tensor(im_b, device=dev))
        steps = {}
        for key, label, args in ((None, CFG_INPUT, gargs),
                                 ("lk_gn random", "random |d|<=4", (t1, t2, *fields, 5, 5, 13))):
            steps[key] = float(gn_exit(lk_iter, *args)[3].double().mean())
            time_kernel("lk_gn", shape, lambda a=args: lk_iter.lk_gn_iterate(*a),
                        lambda a=args: lk_iter.lk_gn_iterate_plain(*a), reps, 20, key=key,
                        gn=steps[key], n_iter=5, input=label, mean_steps=steps[key])
        del t1, t2
        # K7 as the path runs it: right after the build that writes its
        # planes (evict-first), not on planes a previous K7 left in L2
        replays = 20 if small else 3
        t_build = device_ms(lambda: lk_build.lk_build_planes(*bargs), replays)
        t_both = device_ms(lambda: lk_iter.lk_gn_iterate(*lk_build.lk_build_planes(*bargs),
                                                         *gargs[2:]), replays)
        gn_after_build[shape] = t_both - t_build
        print(json.dumps({"kernel": "lk_gn", "shape": list(shape), "input": CFG_INPUT,
                          "after": "lk_build in one graph", "build_device_ms": t_build,
                          "build_and_gn_device_ms": t_both,
                          "gn_after_build_device_ms": t_both - t_build, "gpu": gpu}))
        fargs = (bargs[0], bargs[1], *gargs[2:11], bargs[3], bargs[2], bargs[4], bargs[5])
        time_kernel("lk_fused", shape, lambda: lk_iter.lk_fused(*fargs),
                    lambda: lk_iter.lk_fused_plain(*fargs), reps, 10 if small else 3,
                    gn=steps[None], n_iter=5, input=CFG_INPUT,
                    cluster=lk_iter.fused_plan(5)[0])
        del slab, g_pair, fields, bargs, gargs, fargs
        # the Farneback kernels at the calibrated config: R = 5, window 33
        # Gaussian, 5 iterations for the fused loop
        im = torch.as_tensor(particle_image_pair(shape=shape, seed=0)[0], device=dev)
        srcp = pad2d(im, ((7, 7), (0, 0)), "nearest")
        time_kernel("fb_poly_expand", shape, lambda: poly_expand.poly_expand(srcp, 7, 1.5),
                    lambda: poly_expand.poly_expand_plain(srcp, 7, 1.5), reps, 50, polyN=7,
                    sigma=1.5, input="whole image")
        del im, srcp
        r0, r1 = fb_expansions(shape)
        fx, fy = rand(shape, -4, 4), rand(shape, -4, 4)
        time_kernel("fb_update_matrices", shape,
                    lambda: tent_sample.update_matrices(fx, fy, r0, r1),
                    lambda: tent_sample.update_matrices_plain(fx, fy, r0, r1), reps, 50, R=5,
                    flow="|d|<=4")
        m = tent_sample.update_matrices(z, z, r0, r1)
        taps, mode, scale = windows["gaussian"]
        time_kernel("fb_blur5_flow", shape, lambda: fb_blur.blur5_flow(m, taps, mode, scale),
                    lambda: fb_blur.blur5_flow_plain(m, taps, mode, scale), reps, 50,
                    window="gaussian 33")
        time_kernel("fb_fused", shape,
                    lambda: fb_fused.fb_fused(r0, r1, z, z, 5, taps, mode, scale),
                    lambda: fb_fused.fb_fused_plain(r0, r1, z, z, 5, taps, mode, scale), reps, 10,
                    n_iters=5, window="gaussian 33")

        def unfused():
            """K14's yardstick: the same 5 rounds as K9 then K12 (fb_fused_plain's
            sequence on the kernels), one CUDA graph."""
            u, v = z, z
            for _ in range(5):
                u, v = fb_blur.blur5_flow(tent_sample.update_matrices(u, v, r0, r1), taps, mode,
                                          scale)
            return u, v

        unfused_device[shape] = device_ms(unfused, 10)
        print(json.dumps({"yardstick_of": "fb_fused", "shape": list(shape), "n_iters": 5,
                          "unfused": "fb_update_matrices then fb_blur5_flow, 5 rounds, one graph",
                          "unfused_device_ms": unfused_device[shape],
                          "fb_fused_device_ms": device_times[("fb_fused", shape)], "gpu": gpu}))
        del r0, r1, fx, fy, m
        torch.cuda.empty_cache()
    for name, w in wrappers.items():
        w.launches = saved_counts[name]

    # ---------------------------------------------------------------- 6
    phase("graph")
    from opticalflow_ri_tpu_torch.compile import compiled_pipeline, scan_pipeline
    from opticalflow_ri_tpu_torch.configs import CONFIGS

    def same_or_within(label, got, want):
        """Bit for bit, or named with its difference within the AEE bar."""
        if all(torch.equal(g, w) for g, w in zip(got, want)):
            return 0.0
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        e = aee(to_np(got[0]), to_np(got[1]), to_np(want[0]), to_np(want[1]))
        print(f"NOT BITWISE {label}: max|d|={d!r} AEE {e!r} (bar {AEE_BAR})")
        if not e <= AEE_BAR:
            raise AssertionError(f"{label}: graph replay and eager disagree")
        return d

    def turns(fns: dict, reps: int) -> dict:
        """Per label: median event ms and median host enqueue us of one call,
        the labels in turns, the order alternating each turn."""
        ev, host = {k: [] for k in fns}, {k: [] for k in fns}
        labels = list(fns)
        for i in range(reps):
            for label in (labels if i % 2 == 0 else labels[::-1]):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                fns[label]()
                t1 = time.perf_counter()
                end.record()
                end.synchronize()
                ev[label].append(start.elapsed_time(end))
                host[label].append(1e6 * (t1 - t0))
        return {k: (statistics.median(ev[k]), statistics.median(host[k])) for k in fns}

    def replay_device_ms(fn, a, b, replays=20) -> float:
        """The graph replayed back to back (its input copies included): the
        device's time per pair."""
        fn.replay(a, b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            fn.replay(a, b)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / replays

    h1, h2, _, _ = particle_image_pair(shape=(512, 512), seed=1)
    h1, h2 = torch.as_tensor(h1, device=dev), torch.as_tensor(h2, device=dev)
    graph_times, not_bitwise = {}, {}
    for name in CONFIGS:
        fn = compiled_pipeline(name)
        eager2 = run_config(name, h1, h2)
        fn.warm_up(g1, g2)
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        got = fn(g1, g2)  # the capture, then the first replay
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        captured = {k: w.launches - before[k] for k, w in wrappers.items()}
        if {k for k, c in captured.items() if c} != expected(name):
            raise AssertionError(f"{name}: the capture launched {captured}, expected "
                                 f"{sorted(expected(name))}")
        d = same_or_within(f"{name} 512^2 pair 0", got, flows[name])
        for _ in range(2):  # two pairs in turns: each replay computes its own pair
            d = max(d, same_or_within(f"{name} 512^2 pair 1", fn(h1, h2), eager2),
                    same_or_within(f"{name} 512^2 pair 0", fn(g1, g2), flows[name]))
        if any(w.launches != before[k] + captured[k] for k, w in wrappers.items()):
            raise AssertionError(f"{name}: a replay counted launches")
        if d:
            not_bitwise[name] = d
        t = turns({"eager": lambda n=name: run_config(n, g1, g2),
                   "graph": lambda f=fn: f(g1, g2)}, REPS)
        graph_times[name] = rec = {
            "graph": name, "shape": [512, 512], "bitwise": not d, "max_abs_diff": d,
            "captured_launches": {k: c for k, c in captured.items() if c},
            "capture_s": capture_s, "eager_ms": t["eager"][0], "graph_ms": t["graph"][0],
            "eager_host_us": t["eager"][1], "graph_host_us": t["graph"][1],
            "graph_device_ms": replay_device_ms(fn, g1, g2)}
        print(json.dumps({**rec, "gpu": gpu}), flush=True)
        fn.release()
        del got, eager2

    # one config per solver at 2048^2
    b1, b2, _, _ = particle_image_pair(shape=(2048, 2048), seed=0)
    b1, b2 = torch.as_tensor(b1, device=dev), torch.as_tensor(b2, device=dev)
    for name in ("HS_Fs3_4", "LiuSE_HS_Fs3_4_PyrLvls2", "LK_Fs2_0", "Farneback_Fs0_0"):
        fn = compiled_pipeline(name)
        want = run_config(name, b1, b2)
        t0 = time.perf_counter()
        got = fn(b1, b2)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        d = same_or_within(f"{name} 2048^2", got, want)
        if d:
            not_bitwise[f"{name} 2048^2"] = d
        t = turns({"eager": lambda n=name: run_config(n, b1, b2),
                   "graph": lambda f=fn: f(b1, b2)}, 5)
        print(json.dumps({"graph": name, "shape": [2048, 2048], "bitwise": not d,
                          "max_abs_diff": d, "capture_s": capture_s, "eager_ms": t["eager"][0],
                          "graph_ms": t["graph"][0], "eager_host_us": t["eager"][1],
                          "graph_host_us": t["graph"][1],
                          "graph_device_ms": replay_device_ms(fn, b1, b2, 5), "gpu": gpu}),
              flush=True)
        fn.release()
        del got, want
    del b1, b2
    torch.cuda.empty_cache()
    print(f"graph replay against eager: {len(CONFIGS)} configs at 512^2 and 4 at 2048^2, "
          f"not bit for bit: {not_bitwise or 'none'}")

    # ---------------------------------------------------------------- 7
    phase("scan")
    stacks = [particle_image_pair(shape=(512, 512), seed=s)[:2] for s in range(16)]
    s1 = torch.as_tensor(np.stack([p[0] for p in stacks]), device=dev)
    s2 = torch.as_tensor(np.stack([p[1] for p in stacks]), device=dev)
    for name in ("HS_Fs3_4", "LK_Fs2_0", "Farneback_Fs0_0", "LiuSE_Farneback_Fs0_0_PyrLvls2"):
        scan = scan_pipeline(name)
        us, vs = scan(s1[:4], s2[:4])
        for k in range(4):
            d = same_or_within(f"scan {name} pair {k} of 4", (us[k], vs[k]),
                               run_config(name, s1[k], s2[k]))
            if d:
                not_bitwise[f"scan {name}"] = d

        def eager_loop(n=name):
            for k in range(16):
                run_config(n, s1[k], s2[k])

        t = turns({"eager": eager_loop, "scan": lambda f=scan: f(s1, s2)}, 5)
        print(json.dumps({"scan": name, "shape": [16, 512, 512],
                          "scan_ms": t["scan"][0], "scan_pairs_per_s": 16e3 / t["scan"][0],
                          "eager_loop_ms": t["eager"][0],
                          "eager_pairs_per_s": 16e3 / t["eager"][0],
                          "scan_host_us": t["scan"][1], "gpu": gpu}), flush=True)
        scan.release()
    del s1, s2, us, vs

    # ---------------------------------------------------------------- 8
    phase("campaign")
    import shutil
    import tempfile

    import scipy.io

    from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
    from opticalflow_ri_tpu_torch.utils.io import load_image

    camp = "HS_Fs3_4"
    work = tempfile.mkdtemp(prefix="ofri_campaign_")
    try:
        pairs = []
        for i in range(30):
            a, b, _, _ = particle_image_pair(shape=(512, 512), seed=100 + i)
            paths = [os.path.join(work, f"p{i:02d}_{j}.tif") for j in (0, 1)]
            for p, im in zip(paths, (a, b)):
                write_tiff(p, np.clip(np.rint(im), 0, 255).astype(np.uint8))
            pairs.append((f"p{i:02d}", *paths))
        missing = ("missing", os.path.join(work, "nope_0.tif"), os.path.join(work, "nope_1.tif"))
        pairs.insert(20, missing)
        out = os.path.join(work, "out")
        first = FlowBatchRunner(camp, batch_size=8, output_dir=out).run(pairs[:16])
        state = FlowBatchRunner(camp, batch_size=8, output_dir=out).run(pairs)  # resume
        lost = [p[0] for p in pairs[16:24]]  # the batch that holds the missing pair
        want_done = sorted(p[0] for p in pairs if p[0] not in lost)
        print(f"campaign {camp}: first run done {len(first['done'])}, after the resume done "
              f"{len(state['done'])} failed {sorted(state['failed'])}")
        if sorted(first["done"]) != sorted(p[0] for p in pairs[:16]):
            raise AssertionError(f"campaign: the first run did {first['done']}")
        if sorted(state["done"]) != want_done or sorted(state["failed"]) != sorted(lost):
            raise AssertionError(f"campaign: done {state['done']}, failed {state['failed']}")
        for name, p0, p1 in pairs:
            if name not in want_done:
                continue
            vel = scipy.io.loadmat(os.path.join(out, f"{name}.mat"))["velocities"]
            got = (torch.as_tensor(vel["u"][0, 0]), torch.as_tensor(vel["v"][0, 0]))
            want = run_config(camp, load_image(p0), load_image(p1))
            d = same_or_within(f"campaign {name}", got, [x.cpu() for x in want])
            if d:
                not_bitwise[f"campaign {camp}"] = d
        print(f"campaign: {len(want_done)} .mat files against eager run_config on the decoded "
              f"TIFFs: checked")
        valid = [p for p in pairs if p is not missing]
        steady = FlowBatchRunner(camp, batch_size=8, output_dir=os.path.join(work, "steady"))
        t0 = time.perf_counter()
        st = steady.run(valid)
        wall = time.perf_counter() - t0
        print(json.dumps({"campaign": camp, "pairs": len(st["done"]), "batch_size": 8,
                          "shape": [512, 512], "pairs_per_s": len(st["done"]) / wall,
                          "seconds_per_batch": st["seconds_per_batch"],
                          "compute_wait_s": st["compute_wait_s"],
                          "transfer_save_s": st["transfer_save_s"], "gpu": gpu}), flush=True)
        compiled_pipeline(camp).release()
        print(f"graph, scan and campaign against eager, not bit for bit: "
              f"{not_bitwise or 'none'}")

        # ------------------------------------------------------------ 9
        phase("parallel")
        # the masked kernels' device time at 2048^2: every side an apron edge
        # (an interior tile) beside the whole-image call; masked_parity
        # checks these inputs too
        fx, fy, ft = hs_derivatives(rand(PARALLEL_SHAPE, 0, 255), rand(PARALLEL_SHAPE, 0, 255))
        z = torch.zeros(PARALLEL_SHAPE, device=dev)
        a, b = rand(PARALLEL_SHAPE, 1, 255), rand(PARALLEL_SHAPE, 1, 255)
        fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
        masked = masked_parity(dev, rand, (fx, fy, ft, z, fields))
        sharded_err = sharded_mode_parity(dev, rand, fb_expansions)
        padded_warp_err = warp_padded_parity(rand)
        print(json.dumps({"warp_pair_device_ms": warp_padded_ms(rand, device_ms), "gpu": gpu}),
              flush=True)
        masked_ms = {
            "hs_jacobi 100 it, edges ALL": device_ms(
                lambda: hs_iter.hs_iterate(fx, fy, ft, z, z, 1.0, 100), 20),
            "hs_jacobi 100 it, edges 0": device_ms(
                lambda: hs_iter.hs_iterate(fx, fy, ft, z, z, 1.0, 100, 0), 20),
            "liu_shen 60 steps, edges ALL, stop": device_ms(
                lambda: liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, 0.0), 20),
            "liu_shen 60 steps, edges 0, stop=False": device_ms(
                lambda: liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, 0.0, 0, False),
                20)}
        print(json.dumps({"masked_device_ms": masked_ms, "shape": list(PARALLEL_SHAPE),
                          "gpu": gpu}), flush=True)
        del fx, fy, ft, z, a, b, fields
        torch.cuda.empty_cache()
        print(json.dumps({"stripe_device_ms": stripe_mode_ms(dev, rand, fb_expansions, device_ms),
                          "gpu": gpu}), flush=True)
        with open(os.path.join(work, "pairs.json"), "w") as f:
            json.dump(pairs, f)
        t0 = time.perf_counter()
        nccl_lines = run_group(1, "nccl", work)
        t1 = time.perf_counter()
        lines = run_group(4, "gloo", work)
        t2 = time.perf_counter()
        # K6, K7, K9 and K12 launched by the sharded LK and FB solves on rank
        # 0 (the counts zeroed just before each), summed over the two, in
        # both groups
        sharded_launches = {name: {} for name in sharded_err}
        for group, glines in (("nccl_1_rank", nccl_lines), ("gloo_4_ranks", lines)):
            for rec in (json.loads(line) for line in glines if line.startswith("{")):
                if rec.get("check", "").startswith(("lk_solve_sharded_kernel",
                                                    "farneback_solve_sharded")):
                    for name, per in sharded_launches.items():
                        per[group] = per.get(group, 0) + rec[f"{name}_launches"]
        if any(len(per) != 2 or min(per.values()) < 1 for per in sharded_launches.values()):
            raise AssertionError(f"a sharded-mode kernel was not launched by the sharded LK and "
                                 f"FB solves of both groups: {sharded_launches}")
        # every kernel of route 2's path (K1, K3, K4/K5, K6, K7, K9, K12)
        # launched by rank 0's route-2 runs (the counts zeroed just before
        # each), summed over the configurations, in both groups
        route2_launches = {name: {} for name in ROUTE2_KERNELS}
        route2_runs = {}
        for group, glines in (("nccl_1_rank", nccl_lines), ("gloo_4_ranks", lines)):
            recs = [json.loads(line) for line in glines if line.startswith("{")]
            recs = [r for r in recs if "route2" in r]
            route2_runs[group] = len(recs)
            for rec in recs:
                for name, per in route2_launches.items():
                    per[group] = per.get(group, 0) + rec[f"{name}_launches"]
        want_runs = len(ROUTE2_AT_2048) + sum(1 for n in CONFIGS if n not in HS_SINGLE_LEVEL)
        if any(n != want_runs for n in route2_runs.values()) or any(
                len(per) != 2 or min(per.values()) < 1 for per in route2_launches.values()):
            raise AssertionError(f"route 2 did not run every configuration, or a kernel of its "
                                 f"path was not launched, in both groups: runs {route2_runs}, "
                                 f"launches {route2_launches}")
        # every kernel of route 2's path held against its plain version at
        # every call of every rank's checked runs, in both groups
        route2_plain = {name: {} for name in ROUTE2_KERNELS}
        for group, glines in (("nccl_1_rank", nccl_lines), ("gloo_4_ranks", lines)):
            for rec in (json.loads(line) for line in glines if line.startswith("{")):
                for name, per in rec.get("kernels", {}).items() if "route2_plain" in rec else ():
                    got = route2_plain[name].setdefault(group, {"calls": 0, "max_abs_diff": 0.0,
                                                                "signatures": 0})
                    got["calls"] += per["calls"]
                    got["signatures"] += len(per["signatures"])
                    got["max_abs_diff"] = max(got["max_abs_diff"], per["max_abs_diff"])
        if any(len(per) != 2 or min(g["calls"] for g in per.values()) < 1
               or max(g["max_abs_diff"] for g in per.values()) != 0.0
               for per in route2_plain.values()):
            raise AssertionError(f"a kernel of route 2's path was not held against its plain "
                                 f"version in both groups, or differed: {route2_plain}")
        # the sharded graphs on the one NCCL rank: every configuration at
        # 512^2 and the 2048^2 set replayed, bit for bit (each checked in
        # the rank); the replayed runs whose capture launched each kernel
        graphs = [r for r in (json.loads(line) for line in nccl_lines if line.startswith("{"))
                  if "graph_sharded" in r]
        want_graphs = len(CONFIGS) + 1 + len(ROUTE2_AT_2048)
        if len(graphs) != want_graphs or not all(r["ok"] for r in graphs):
            raise AssertionError(f"the one NCCL rank replayed {len(graphs)} sharded graphs, "
                                 f"{want_graphs} expected, or one disagreed")
        graph_runs = {name: sum(1 for r in graphs
                                if r["capture"].get(f"{name}_launches", 0) > 0)
                      for name in ROUTE2_KERNELS}
        if min(graph_runs.values()) < 1:
            raise AssertionError(f"a kernel of routes 1 and 2 is in no sharded graph: {graph_runs}")
        # the biLinear=False path: the tile warp bit for bit at every flow,
        # size and mesh, and the pyramids' K1 and K4/K5 launches (the counts
        # zeroed just before each run) and calls held against their plain
        # versions, in both groups; their graphs on the one NCCL rank
        ls_launches = {k: {} for k in LS_WARP_KERNELS.values()}
        ls_plain = {k: {} for k in LS_WARP_KERNELS.values()}
        ls_checks = {}
        for group, glines, n_mesh in (("nccl_1_rank", nccl_lines, 1), ("gloo_4_ranks", lines, 2)):
            recs = [json.loads(line) for line in glines if line.startswith("{")]
            warps = [r for r in recs if "ls_warp" in r]
            pyrs = [r for r in recs if "ls_warp_pyramid" in r]
            ls_checks[group] = {"tile_warps": len(warps), "pyramids": len(pyrs)}
            if len(warps) != 3 * 2 * n_mesh or len(pyrs) != 2 * 2 * n_mesh or not all(
                    r["ok"] for r in warps + pyrs):
                raise AssertionError(f"the {group} group ran {len(warps)} tile warps and "
                                     f"{len(pyrs)} biLinear=False pyramids, {6 * n_mesh} and "
                                     f"{4 * n_mesh} expected, or one disagreed")
            for rec in pyrs:
                for name, per in ls_launches.items():
                    per[group] = per.get(group, 0) + rec[f"{name}_launches"]
                for name, per in rec["plain"].items():
                    got = ls_plain[name].setdefault(group, {"calls": 0, "max_abs_diff": 0.0})
                    got["calls"] += per["calls"]
                    got["max_abs_diff"] = max(got["max_abs_diff"], per["max_abs_diff"])
        if any(len(per) != 2 or min(per.values()) < 1 for per in ls_launches.values()) or any(
                len(per) != 2 or min(g["calls"] for g in per.values()) < 1
                or max(g["max_abs_diff"] for g in per.values()) != 0.0
                for per in ls_plain.values()):
            raise AssertionError(f"K1 or K4/K5 was not launched by the biLinear=False pyramids "
                                 f"of both groups, or differed from its plain version: "
                                 f"launches {ls_launches}, plain {ls_plain}")
        ls_graphs = [r for r in (json.loads(line) for line in nccl_lines if line.startswith("{"))
                     if "ls_warp_graph" in r]
        if len(ls_graphs) != 2 * len(LS_WARP_PYRAMIDS) or not all(r["ok"] for r in ls_graphs):
            raise AssertionError(f"the one NCCL rank replayed {len(ls_graphs)} biLinear=False "
                                 f"graphs, {2 * len(LS_WARP_PYRAMIDS)} expected, or one disagreed")
        ls_graph_runs = {name: sum(1 for r in ls_graphs
                                   if r["capture"].get(f"{name}_launches", 0) > 0)
                         for name in LS_WARP_KERNELS.values()}
        print(json.dumps({"parallel": "biLinear=False", "checks": ls_checks,
                          "launches": ls_launches, "plain": ls_plain,
                          "graph_runs": ls_graph_runs, "gpu": gpu}), flush=True)
        print(json.dumps({"parallel": "sharded graphs, one NCCL rank", "runs": len(graphs),
                          "route1_runs": sum(r["route"] == 1 for r in graphs),
                          "route2_runs": sum(r["route"] == 2 for r in graphs),
                          "runs_per_kernel": graph_runs, "gpu": gpu}), flush=True)
        runner = [json.loads(line) for line in lines if '"runner"' in line]
        if not runner:
            raise AssertionError("the four-rank group reported no runner result")
        rec = runner[-1]
        if rec["first_done"] != sorted(first["done"]) or rec["done"] != sorted(state["done"]) \
                or rec["failed"] != sorted(state["failed"]):
            raise AssertionError(f"the mesh runner's done/failed {rec} differ from the "
                                 f"single-device runner's")
        for name in rec["done"]:
            got, want = (scipy.io.loadmat(os.path.join(work, d, f"{name}.mat"))["velocities"]
                         for d in ("out_mesh", "out"))
            if not all(np.array_equal(got[k][0, 0], want[k][0, 0]) for k in ("u", "v")):
                raise AssertionError(f"mesh runner: {name}.mat differs from the single-device "
                                     f"runner's")
        print(f"mesh runner: done {len(rec['done'])} and failed {rec['failed']} equal the "
              f"single-device runner's; every .mat bit for bit")
        print(json.dumps({"parallel": "groups", "masked_max_abs_diff": masked,
                          "sharded_mode_max_abs_diff": sharded_err,
                          "sharded_launches": sharded_launches,
                          "warp_padded_max_abs_diff": padded_warp_err,
                          "route2_launches": route2_launches, "route2_runs": route2_runs,
                          "route2_plain": route2_plain,
                          "nccl_1_rank_s": t1 - t0, "gloo_4_ranks_s": t2 - t1, "gpu": gpu}),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---------------------------------------------------------------- result
    # name: (source, the TPU kernel it replaces or None, the others it also
    # replaces)
    replaced = {
        "hs_jacobi": ("hs_jacobi.cu", "hs_iter.py:113", ["hs_tiled.py:164"]),
        "warp_pair": ("warp_pair.cu", "warp_tent.py:120", []),
        "liu_shen": ("liu_shen.cu", "liu_shen_iter.py:108", ["ls_tiled.py:245"]),
        "lk_build": ("lk_build.cu", "lk_build.py:173", []),
        "lk_gn": ("lk_iter.cu", "lk_iter.py:153", []),
        "lk_fused": ("lk_iter.cu", "lk_iter.py:320", []),
        "fb_poly_expand": ("fb_poly_expand.cu", None, []),
        "fb_update_matrices": ("fb_update_matrices.cu", "tent_sample.py:336",
                               ["tent_sample.py:223", "tent_sample.py:531"]),
        "fb_blur5_flow": ("fb_blur5_flow.cu", "blur5_flow.py:124", ["blur5_flow.py:196"]),
        "fb_fused": ("fb_fused.cu", "fb_fused2.py:163", []),
    }
    kernels = []
    for name, (src, tpu, also) in replaced.items():
        b, by = bounds[(name, (512, 512))]
        kern = {"name": name, "route": "cuda", "source": f"opticalflow_ri_tpu_torch/csrc/{src}",
                "replaces": tpu and f"opticalflow_ri_tpu/ops/pallas/{tpu}",
                "launches": launches[name], "max_abs_err": err[name],
                "ms": kernel_times[(name, (512, 512))][0],
                "plain_ms": kernel_times[(name, (512, 512))][1],
                "bound_ms": b, "bound_by": by,
                "library_ms": library_times.get((name, (512, 512)))}
        if also:
            kern["also_replaces"] = [f"opticalflow_ri_tpu/ops/pallas/{t}" for t in also]
        kern["device_ms"] = device_times[(name, (512, 512))]
        if name in ("lk_gn", "lk_fused"):
            kern["input"] = CFG_INPUT + ", particle_image_pair((512, 512), seed=0)"
        if name == "lk_gn":  # on the path K7 follows K6, whose planes reach it from HBM
            kern["device_ms_warm"] = kern["device_ms"]
            kern["device_ms"] = gn_after_build[(512, 512)]
            kern["device_ms_of"] = "lk_build then lk_gn in one CUDA graph, less lk_build alone"
        if name == "fb_fused":  # the yardstick: the unfused rounds on the same input
            kern["unfused_device_ms"] = unfused_device[(512, 512)]
        if tpu is None:  # the JAX package runs this stage as XLA ops
            kern["internal"] = "port-internal: no TPU kernel"
        if (name, (512, 512)) in library_device_times:
            kern["library_device_ms"] = library_device_times[(name, (512, 512))]
        if name in sharded_err:  # the rows-sharded LK and FB solves' modes
            kern["sharded_max_abs_err"] = sharded_err[name]
            kern["sharded_launches"] = sharded_launches[name]
        if name == "warp_pair":  # the sharded pyramid's caller-padded mode
            kern["padded_max_abs_err"] = padded_warp_err
        if name == "liu_shen":  # the device gate of the sharded solve's stop
            kern["gated_max_abs_err"] = gated_err
        if name in graph_runs:  # sharded runs replayed as one CUDA graph
            kern["sharded_graph_runs"] = graph_runs[name]
        if name in ls_launches:   # the biLinear=False pyramids on tiles
            kern["ls_warp_launches"] = ls_launches[name]
            kern["ls_warp_max_abs_err"] = max(g["max_abs_diff"] for g in ls_plain[name].values())
            kern["ls_warp_checked_calls"] = {g: per["calls"] for g, per in ls_plain[name].items()}
            kern["ls_warp_graph_runs"] = ls_graph_runs[name]
        if name in route2_launches:
            kern["route2_launches"] = route2_launches[name]
            kern["route2_max_abs_err"] = max(g["max_abs_diff"]
                                             for g in route2_plain[name].values())
            kern["route2_checked_calls"] = {g: per["calls"]
                                            for g, per in route2_plain[name].items()}
        kernels.append(kern)
    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was never launched by the main path")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
