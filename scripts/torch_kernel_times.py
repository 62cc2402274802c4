#!/usr/bin/env python3
"""Time the port's HS Jacobi (K1/K2), Liu-Shen solve (K4/K5), LK plane build
(K6), LK Gauss-Newton (K7) and fused LK (K8), Farneback window blur + solve
(K12/K13), fused Farneback loop (K14), Farneback expansion and pair warp (K3)
kernels on one GPU.

    python3 scripts/torch_kernel_times.py [--root DIR] [--shapes 512 2048]
        [--hs-steps 4 8 16] [--hs-niters 100] [--ls-steps 4 8 12]
        [--skip hs ls lk fb expand warp] [--configs NAME ...] [--reps 15]

For each square shape: HS (alpha 21, random derivatives of two uniform
frames, zero flow); Liu-Shen (h = 10, fields of two uniform frames, zero
flow, 60 steps) with tol = 0 and with a tol that stops the plain solve near
step 30; the LK build at half window 13, R = 5 (121 shifts, the symmetric
window) on a rolled noisy random pair; the LK GN loop (5 steps) on two
inputs, the configs' own (the arguments ``lk_gn_iterate`` receives in one
``run_config("LK_Fs2_0")`` on the particle pair of that shape, seed 0) and a
random per-pixel flow of |d| <= 4 on the rolled pair's planes, each with
the mean GN steps a pixel runs (``gn_exit``) and, on the
configs' input, right after the build that writes its planes; the fused LK
solve on the configs' input; the FB blur + solve at 33 taps, the
Gaussian ("mirror") and the box ("nearest", post-scale 1/33^2) window, on
the M of a particle pair at zero flow; the fused FB loop on that pair's
expansions from zero flow (33-tap Gaussian) at 0, 1 and 5 rounds (the
fixed cost and the cost a round), with
``unfused_device_ms``, the same rounds as K9 then K12 (``fb_fused_plain``'s
sequence on the kernels) in one CUDA graph, and ``bitwise`` against the plain
loop; the FB expansion (polyN 7, polySigma 1.5) of a particle frame with
the replicate rule's rows, as ``farneback_solve`` runs it
(``poly_expansion_padded``: the kernel, or in a tree without it the
PyTorch op chain, ``expansion_device_ms``), and where the tree has the
kernel, the kernel against its plain version (``bitwise``, ``event_ms``,
``device_ms``); the pair warp on two uniform frames and |d| <= 4 flows, the
whole-image call and, where the tree has it, the caller-padded mode on an
interior tile of half the height and width (``bitwise_whole_cropped``
against the whole-image call).  Per kernel call it prints one JSON line with
  * ``event_ms``: median of CUDA-event intervals around one synchronised call,
    the kernel and its plain PyTorch version in alternating turns;
  * ``device_ms``: the call captured once in a CUDA graph and replayed
    back to back, events over the replays divided by their count: the
    device's time per call without the host's enqueue;
  * ``host_ms``: the host's time to enqueue one call (wall clock, no sync);
  * ``bound_ms``: the least time of the call (``bound_ms``): for K1, K4/K5, K6
    and K7 the benchmark's own count of the stage (``pivbench/work.py``,
    ``pivbench/lk_work.py``), for the others ``KERNEL_COSTS`` here.
``--hs-niters`` sets the HS iteration counts (default 100); ``--hs-steps``
and ``--ls-steps`` repeat the HS and Liu-Shen kernels at those steps per
launch (``hs_iter.STEPS_PER_LAUNCH``, ``liu_shen_iter.STEPS_PER_LAUNCH``; a
tree without it is timed at its own design).
``--configs`` also times those configs end to end (``run_config`` on the
512^2 synthetic pair, one call of each per turn: median and quartiles of the
event intervals, and the host's enqueue time per call).  ``--root`` imports the
package from another checkout, so that two trees can be compared in one
machine session, one process each.  Needs a GPU; the last line is the
card's name and power limit.  Importing the script needs no card: the
card-side tests load ``capture_lk_args`` from it, the CPU tests ``gn_exit``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from pivbench import lk_work, work  # noqa: E402


def _own(nbytes_per_px, ops_per_px):
    return lambda h, w, **_: (nbytes_per_px * h * w, ops_per_px * h * w)


def _lk_fused(h, w, gn_steps=5, **_):
    """The J slab at R = 5, the gradient pair's planes, the eleven fields
    and outputs; the two-level window sums' 10 adds a pass and ~60
    operations a GN step."""
    slab, core, n = (h + 41) * (w + 41), (h + 31) * (w + 31), h * w
    return 4 * (slab + 2 * core + 11 * n), (2 * 121 * 21 + 60 * gn_steps) * n


# (bytes, operations) of one call on an h x w image, each input read once and
# each output written once, of the kernels the benchmark counts no stage for:
# K3 (both images and four flows in, two out; 36 operations an image), K8 (at
# R = 5 and ``gn_steps`` mean GN steps a pixel), K9 alone (~100 operations a
# pixel), K12 alone (five planes, two passes of 33 taps, a product and a sum
# each, and the 2x2 solve) and the FB expansion at polyN 7 (43 vertical and 87
# horizontal taps, a product and a sum each, 8 for the combinations; the
# source in, five planes out).  K14's rounds are the benchmark's
# ``fb_iterate``.
KERNEL_COSTS = {
    "warp_pair": _own(32, 72),
    "lk_fused": _lk_fused,
    "fb_update_matrices": _own(68, 100),
    "fb_blur5_flow": _own(28, 5 * 2 * 33 * 2 + 15),
    "fb_poly_expand": _own(24, 2 * (43 + 87) + 8),
}


def kernel_cost(name: str, h: int, w: int, niter: float = 100, gn_steps: float = 5,
                rounds: int = 5) -> tuple:
    """(bytes, operations) of one call of kernel ``name`` on an h x w image:
    HS at ``niter`` iterations, Liu-Shen at ``niter`` steps, the LK build at
    R = 5, K7 and K8 at ``gn_steps`` mean steps a pixel, K14 at ``rounds``
    rounds of 33 taps."""
    n = h * w
    if name == "hs_jacobi":
        return work.hs_iterate(n, niter)
    if name == "liu_shen":
        return work.ls_iterate(n, niter)
    if name == "lk_build":
        return lk_work.lk_build(h, w)
    if name == "lk_gn":
        return lk_work.lk_iterate(h, w, gn_steps)
    if name == "fb_fused":
        return work.fb_iterate(n, rounds)
    return KERNEL_COSTS[name](h, w, gn_steps=gn_steps)


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time of a call in ms (``pivbench.work.least_seconds``), and
    whether its bytes or its operations set it."""
    by = "bytes" if nbytes / work.HBM_BYTES_PER_S >= ops / work.FP32_OPS_PER_S else "operations"
    return 1e3 * work.least_seconds(nbytes, ops), by


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--shapes", type=int, nargs="*", default=[512, 2048])
    ap.add_argument("--hs-steps", type=int, nargs="*", default=[])
    ap.add_argument("--hs-niters", type=int, nargs="+", default=[100])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--ls-steps", type=int, nargs="*", default=[])
    ap.add_argument("--skip", nargs="*", default=[], choices=["hs", "ls", "lk", "fb", "expand", "warp"])
    ap.add_argument("--configs", nargs="*", default=[],
                    help="also time these configs end to end on the 512^2 pair")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a GPU")
    sys.path.insert(0, os.path.abspath(args.root))  # ahead of HERE
    from opticalflow_ri_tpu_torch.configs import run_config
    from opticalflow_ri_tpu_torch.models.farneback import (
        _window_blur_spec, poly_expansion, poly_expansion_padded,
    )
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs
    from opticalflow_ri_tpu_torch.ops.cuda import blur5_flow, hs_iter, liu_shen_iter, lk_build
    from opticalflow_ri_tpu_torch.ops.cuda import fb_fused, lk_iter
    from opticalflow_ri_tpu_torch.ops.cuda import tent_sample, warp_tent
    from opticalflow_ri_tpu_torch.ops.padding import pad2d
    from opticalflow_ri_tpu_torch.ops.stencil import hs_derivatives
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    tree = os.path.basename(os.path.abspath(args.root))
    rng = np.random.default_rng(0)

    def rand(shape, lo, hi):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    def event_ms(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def ab(kernel_fn, plain_fn, reps):
        kernel_fn(), plain_fn()
        k, p = [], []
        for i in range(reps):
            pair = [(k, kernel_fn), (p, plain_fn)]
            for acc, fn in (pair if i % 2 == 0 else pair[::-1]):
                acc.append(event_ms(fn))
        return statistics.median(k), statistics.median(p)

    def host_ms(fn, reps: int) -> float:
        """Median host time to enqueue one call, the queue drained before each."""
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return statistics.median(out)

    def device_ms(fn, replays: int) -> float:
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / replays

    def emit(**rec):
        print(json.dumps({"tree": tree, **rec, "gpu": gpu}), flush=True)

    im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)
    g1, g2 = torch.as_tensor(im1, device=dev), torch.as_tensor(im2, device=dev)
    # configs in turns, one call of each per turn: event interval median and
    # quartiles, and the host's enqueue time per call
    runs = {name: (lambda name=name: run_config(name, g1, g2)) for name in args.configs}
    events = {name: [] for name in runs}
    for fn in runs.values():
        fn()
    for _ in range(args.reps):
        for name, fn in runs.items():
            events[name].append(event_ms(fn))
    for name, fn in runs.items():
        q1, med, q3 = statistics.quantiles(events[name], n=4)
        emit(config=name, shape=[512, 512], event_ms=med, event_q1_ms=q1, event_q3_ms=q3,
             host_ms=host_ms(fn, args.reps))

    for n in args.shapes:
        shape = (n, n)
        reps = args.reps if n <= 1024 else max(3, args.reps // 3)
        if "hs" not in args.skip:
            fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
            z = torch.zeros(shape, device=dev)
            design = getattr(hs_iter, "STEPS_PER_LAUNCH", 1)  # 1: one launch per iteration
            for steps in (args.hs_steps if design > 1 else []) or [design]:
                if design > 1:
                    hs_iter.STEPS_PER_LAUNCH = steps
                for niter in args.hs_niters:
                    b, by = bound_ms(*kernel_cost("hs_jacobi", n, n, niter))

                    def kernel(niter=niter):
                        return hs_iter.hs_iterate(fx, fy, ft, z, z, 21.0, niter)

                    def plain(niter=niter):
                        return hs_iter.hs_iterate_plain(fx, fy, ft, z, z, 21.0, niter)

                    k, p = ab(kernel, plain, reps)
                    emit(kernel="hs_jacobi", shape=list(shape), niter=niter,
                         steps_per_launch=steps, event_ms=k, plain_event_ms=p,
                         device_ms=device_ms(kernel, 20), host_ms=host_ms(kernel, reps),
                         bound_ms=b, bound_by=by)
            hs_iter.STEPS_PER_LAUNCH = design
            del fx, fy, ft, z
        if "ls" not in args.skip:
            a, b = rand(shape, 1, 255), rand(shape, 1, 255)
            fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
            z = torch.zeros(shape, device=dev)
            # a tol between the errs of the plain solve's steps near 30
            errs, u, v = [], z, z
            for _ in range(60):
                un, vn = liu_shen_iter.liu_shen_iteration(u, v, fields, 10.0)
                errs.append(float((torch.linalg.norm(un - u) + torch.linalg.norm(vn - v))
                                  / u.numel()))
                u, v = un, vn
            k_stop = min(range(2, 60), key=lambda k: (
                not (errs[k - 1] < errs[k - 2] * 0.99 and min(errs[:k - 1]) == errs[k - 2]),
                abs(k - 30)))
            stop = float(np.sqrt(errs[k_stop - 2] * errs[k_stop - 1]))
            design = getattr(liu_shen_iter, "STEPS_PER_LAUNCH", 1)  # 1: one launch per step
            for steps in (args.ls_steps if design > 1 else []) or [design]:
                if design > 1:
                    liu_shen_iter.STEPS_PER_LAUNCH = steps
                for label, tol, k in (("fixed", 0.0, 60), ("early-stop", stop, k_stop)):
                    b, by = bound_ms(*kernel_cost("liu_shen", n, n, k))

                    def kernel(tol=tol):
                        return liu_shen_iter.liu_shen_iterate(10.0, fields, z, z, 60, tol)

                    def plain(tol=tol):
                        return liu_shen_iter.liu_shen_iterate_plain(10.0, fields, z, z, 60, tol)

                    k_got = int(kernel()[3])
                    kt, pt = ab(kernel, plain, reps)
                    emit(kernel="liu_shen", shape=list(shape), max_iter=60, stop=label,
                         tol=tol, k=k_got, steps_per_launch=steps, event_ms=kt,
                         plain_event_ms=pt, device_ms=device_ms(kernel, 20),
                         host_ms=host_ms(kernel, reps), bound_ms=b, bound_by=by)
            liu_shen_iter.STEPS_PER_LAUNCH = design
            del a, b, fields, z, u, v, un, vn
            torch.cuda.empty_cache()
        if "lk" not in args.skip:
            a = rng.uniform(0, 255, shape).astype(np.float32)
            bimg = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
            z = torch.zeros(shape, device=dev)
            slab, g_pair, _, runs_y, runs_x = lk_kernel_inputs(
                torch.as_tensor(a, device=dev), torch.as_tensor(bimg, device=dev), z, z)

            def kernel():
                return lk_build.lk_build_planes(slab, g_pair, 13, 5, runs_y, runs_x)

            def plain():
                return lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, runs_y, runs_x)

            k, p = ab(kernel, plain, reps)
            torch.cuda.empty_cache()
            b, by = bound_ms(*kernel_cost("lk_build", n, n))
            emit(kernel="lk_build", shape=list(shape), shifts=121, event_ms=k, plain_event_ms=p,
                 device_ms=device_ms(kernel, 10 if n <= 1024 else 3), host_ms=host_ms(kernel, reps),
                 bound_ms=b, bound_by=by)
            # K7 on two inputs: the configs' own (what lk_gn_iterate receives in
            # one run_config("LK_Fs2_0") on the particle pair of this shape: a
            # smooth flow from u0 = v0 = 0) and a random per-pixel flow of
            # |d| <= 4 on the rolled pair's planes (the card tests' parity input)
            im_a, im_b, _, _ = particle_image_pair(shape=shape, seed=0)
            bargs, cfg_gn = capture_lk_args(run_config, lk_build, lk_iter, "LK_Fs2_0",
                                            torch.as_tensor(im_a, device=dev),
                                            torch.as_tensor(im_b, device=dev))
            t1, t2 = kernel()
            rand_fields = lk_kernel_inputs(torch.as_tensor(a, device=dev),
                                           torch.as_tensor(bimg, device=dev),
                                           rand(shape, -4, 4), rand(shape, -4, 4))[2]
            inputs = {"configs (LK_Fs2_0)": cfg_gn, "random |d|<=4": (t1, t2, *rand_fields,
                                                                       5, 5, 13)}
            for label, gargs in inputs.items():
                steps = float(gn_exit(lk_iter, *gargs)[3].double().mean())
                same = all(torch.equal(g, w_) for g, w_ in
                           zip(lk_iter.lk_gn_iterate(*gargs), lk_iter.lk_gn_iterate_plain(*gargs)))
                b, by = bound_ms(*kernel_cost("lk_gn", n, n, gn_steps=steps))

                def gn(gargs=gargs):
                    return lk_iter.lk_gn_iterate(*gargs)

                def gn_plain(gargs=gargs):
                    return lk_iter.lk_gn_iterate_plain(*gargs)

                k, p = ab(gn, gn_plain, reps)
                emit(kernel="lk_gn", shape=list(shape), input=label, n_iter=gargs[-3],
                     mean_steps=steps, bitwise=same, event_ms=k, plain_event_ms=p,
                     device_ms=device_ms(gn, 20), host_ms=host_ms(gn, reps), bound_ms=b,
                     bound_by=by)
            # K7 right after K6 writes the planes (evict-first stores), against
            # K7 replayed on planes a previous K7 left in L2: the configs' input
            cfg_fields = cfg_gn[2:]

            def build_cfg():
                return lk_build.lk_build_planes(*bargs)

            def build_then_gn():
                return lk_iter.lk_gn_iterate(*build_cfg(), *cfg_fields)

            t_build, t_both = device_ms(build_cfg, 10), device_ms(build_then_gn, 10)
            emit(kernel="lk_gn", shape=list(shape), input="configs (LK_Fs2_0)",
                 after="lk_build in the same graph", build_device_ms=t_build,
                 build_and_gn_device_ms=t_both, gn_after_build_device_ms=t_both - t_build)
            # K8 on the configs' input: the build's slab, gradients and runs,
            # the GN's fields
            fargs = (bargs[0], bargs[1], *cfg_fields[:8], cfg_fields[8], bargs[3], bargs[2],
                     bargs[4], bargs[5])

            def fused():
                return lk_iter.lk_fused(*fargs)

            def fused_plain():
                return lk_iter.lk_fused_plain(*fargs)

            steps = float(gn_exit(lk_iter, *cfg_gn)[3].double().mean())
            b, by = bound_ms(*kernel_cost("lk_fused", n, n, gn_steps=steps))
            same = all(torch.equal(g, w_) for g, w_ in zip(fused(), fused_plain()))
            k, p = ab(fused, fused_plain, reps if n <= 1024 else 3)
            emit(kernel="lk_fused", shape=list(shape), input="configs (LK_Fs2_0)",
                 bitwise=same, event_ms=k, plain_event_ms=p,
                 device_ms=device_ms(fused, 10 if n <= 1024 else 3),
                 build_only_device_ms=device_ms(
                     lambda: lk_iter.lk_fused(*fargs[:10], 0, *fargs[11:]),
                     10 if n <= 1024 else 3),
                 host_ms=host_ms(fused, reps), bound_ms=b, bound_by=by)
            del slab, g_pair, t1, t2, bargs, cfg_gn, inputs, rand_fields, fargs
            torch.cuda.empty_cache()
        if "fb" not in args.skip:
            im_a, im_b, _, _ = particle_image_pair(shape=shape, seed=0)
            r0, r1 = (poly_expansion(torch.as_tensor(im, device=dev), 7, 1.5).contiguous()
                      for im in (im_a, im_b))
            z = torch.zeros(shape, device=dev)
            m = tent_sample.update_matrices(z, z, r0, r1)
            b, by = bound_ms(*kernel_cost("fb_blur5_flow", n, n))
            for window in ("gaussian", "box"):
                taps, mode, scale = _window_blur_spec(33, window == "gaussian")

                def kernel():
                    return blur5_flow.blur5_flow(m, taps, mode, scale)

                def plain():
                    return blur5_flow.blur5_flow_plain(m, taps, mode, scale)

                k, p = ab(kernel, plain, reps)
                emit(kernel="fb_blur5_flow", shape=list(shape), taps=33, window=window,
                     event_ms=k, plain_event_ms=p, device_ms=device_ms(kernel, 50),
                     host_ms=host_ms(kernel, reps), bound_ms=b, bound_by=by,
                     issue_floor_ms=2 * b)
            # K14 from zero flow, Gaussian window, at 0, 1 and 5 rounds (the
            # fixed cost and the cost a round), beside the unfused loop: K9 then
            # K12 each round (fb_fused_plain's sequence, on the kernels) as one
            # CUDA graph
            taps, mode, scale = _window_blur_spec(33, True)
            for n_iters in (0, 1, 5):
                def fused(n_iters=n_iters):
                    return fb_fused.fb_fused(r0, r1, z, z, n_iters, taps, mode, scale)

                def fused_plain(n_iters=n_iters):
                    return fb_fused.fb_fused_plain(r0, r1, z, z, n_iters, taps, mode, scale)

                def unfused(n_iters=n_iters):
                    fx, fy = z, z
                    for _ in range(n_iters):
                        fx, fy = blur5_flow.blur5_flow(
                            tent_sample.update_matrices(fx, fy, r0, r1), taps, mode, scale)
                    return fx, fy

                same = all(torch.equal(g, w_) for g, w_ in zip(fused(), fused_plain()))
                k, p = ab(fused, fused_plain, reps)
                # at 0 rounds the kernel copies the flow: no round to bound
                b, by = (bound_ms(*kernel_cost("fb_fused", n, n, rounds=n_iters)) if n_iters
                         else (None, None))
                emit(kernel="fb_fused", shape=list(shape), n_iters=n_iters, taps=33,
                     window="gaussian", bitwise=same, event_ms=k, plain_event_ms=p,
                     device_ms=device_ms(fused, 20),
                     unfused_device_ms=device_ms(unfused, 20) if n_iters else None,
                     host_ms=host_ms(fused, reps), bound_ms=b, bound_by=by,
                     issue_floor_ms=2 * b if n_iters else None)
            del r0, r1, m, z
            torch.cuda.empty_cache()
        if "expand" not in args.skip:
            im_a, _, _, _ = particle_image_pair(shape=shape, seed=0)
            srcp = pad2d(torch.as_tensor(im_a, device=dev), ((7, 7), (0, 0)), "nearest")
            b, by = bound_ms(*kernel_cost("fb_poly_expand", n, n))
            rec = dict(kernel="fb_poly_expand", shape=list(shape), poly_n=7, poly_sigma=1.5,
                       expansion_device_ms=device_ms(
                           lambda: poly_expansion_padded(srcp, 7, 1.5), 20),
                       bound_ms=b, bound_by=by)
            try:
                from opticalflow_ri_tpu_torch.ops.cuda import poly_expand
            except ImportError:  # a tree without the kernel
                poly_expand = None
            if poly_expand is not None:
                def kernel():
                    return poly_expand.poly_expand(srcp, 7, 1.5)

                def plain():
                    return poly_expand.poly_expand_plain(srcp, 7, 1.5)

                k, p = ab(kernel, plain, reps)
                rec.update(bitwise=torch.equal(kernel(), plain()), event_ms=k, plain_event_ms=p,
                           device_ms=device_ms(kernel, 50), plain_device_ms=device_ms(plain, 10),
                           host_ms=host_ms(kernel, reps))
            emit(**rec)
            del srcp
            torch.cuda.empty_cache()
        if "warp" not in args.skip:
            # K3, the pair warp (|d| <= 4): the whole-image call, and where
            # the tree has it the caller-padded mode on an interior tile of
            # half the height and width (an 8-cell apron of the neighbours'
            # cells on every side)
            ims = [rand(shape, 0, 255) for _ in range(2)]
            flows = [rand(shape, -4, 4) for _ in range(4)]

            def kernel():
                return warp_tent.warp_pair(*ims, *flows)

            def plain():
                return warp_tent.warp_pair_plain(*ims, *flows)

            k, p = ab(kernel, plain, reps)
            b, by = bound_ms(*kernel_cost("warp_pair", n, n))
            emit(kernel="warp_pair", shape=list(shape), mode="whole image", event_ms=k,
                 plain_event_ms=p, device_ms=device_ms(kernel, 50), host_ms=host_ms(kernel, reps),
                 bound_ms=b, bound_by=by)
            if "apron" in inspect.signature(warp_tent.warp_pair).parameters:
                a, th, tw = 8, n // 2, n // 2
                r0 = c0 = n // 4
                tiles = [pad2d(im, a, "nearest")[r0:r0 + th + 2 * a, c0:c0 + tw + 2 * a]
                         .contiguous() for im in ims]
                cut = [f[r0:r0 + th, c0:c0 + tw].contiguous() for f in flows]
                tile = dict(apron=a, row0=r0, col0=c0, img_h=n, img_w=n)

                def padded():
                    return warp_tent.warp_pair(*tiles, *cut, **tile)

                def padded_plain():
                    return warp_tent.warp_pair_plain(*tiles, *cut, **tile)

                same = all(torch.equal(g, w_[r0:r0 + th, c0:c0 + tw])
                           for g, w_ in zip(padded(), kernel()))
                k, p = ab(padded, padded_plain, reps)
                b, by = bound_ms(*kernel_cost("warp_pair", th, tw))
                emit(kernel="warp_pair", shape=[th, tw], mode=f"padded, interior tile of {n}^2",
                     bitwise_whole_cropped=same, event_ms=k, plain_event_ms=p,
                     device_ms=device_ms(padded, 50), host_ms=host_ms(padded, reps),
                     bound_ms=b, bound_by=by)
            del ims, flows
            torch.cuda.empty_cache()
    print(gpu)


if __name__ == "__main__":
    main()
