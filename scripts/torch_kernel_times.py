#!/usr/bin/env python3
"""Time the port's HS Jacobi kernel (K1/K2) and LK plane build (K6) on one GPU.

    python3 scripts/torch_kernel_times.py [--root DIR] [--shapes 512 2048]
        [--hs-steps 4 8 16] [--hs-niters 100] [--configs NAME ...] [--reps 15]

For each square shape: HS (alpha 21, random derivatives of two uniform
frames, zero flow) and the LK build at half window 13, R = 5 (121 shifts,
the symmetric window) on a rolled noisy random pair.  Per kernel call it
prints one JSON line with
  * ``event_ms``: median of CUDA-event intervals around one synchronised call,
    the kernel and its plain PyTorch version in alternating turns, as
    ``chip_smoke.py`` times them;
  * ``device_ms``: the call captured once in a CUDA graph and replayed
    back to back, events over the replays divided by their count: the
    device's time per call without the host's enqueue;
  * ``host_ms``: the host's time to enqueue one call (wall clock, no sync);
  * ``bound_ms``: ``chip_smoke.bound_ms`` of ``chip_smoke.kernel_costs``.
``--hs-niters`` sets the HS iteration counts (default 100); ``--hs-steps``
repeats the HS kernel at those iterations per launch (``hs_iter.
STEPS_PER_LAUNCH``; a tree without it is timed at its own design).
``--configs`` also times those configs end to end (``run_config`` on the
512^2 synthetic pair, median event interval).  ``--root`` imports the
package from another checkout, so that two trees can be compared in one
machine session, one process each.  Needs a GPU; the last line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import bound_ms, kernel_costs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--shapes", type=int, nargs="*", default=[512, 2048])
    ap.add_argument("--hs-steps", type=int, nargs="*", default=[])
    ap.add_argument("--hs-niters", type=int, nargs="+", default=[100])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--skip", nargs="*", default=[], choices=["hs", "lk"])
    ap.add_argument("--configs", nargs="*", default=[],
                    help="also time these configs end to end on the 512^2 pair")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a GPU")
    sys.path.insert(0, os.path.abspath(args.root))  # ahead of HERE
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs
    from opticalflow_ri_tpu_torch.ops.cuda import hs_iter, lk_build
    from opticalflow_ri_tpu_torch.configs import run_config
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
    for name in args.configs:
        run_config(name, g1, g2)
        emit(config=name, shape=[512, 512],
             event_ms=statistics.median(event_ms(lambda: run_config(name, g1, g2))
                                        for _ in range(args.reps)))

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
                    b, by = bound_ms(*kernel_costs(n, n, niter)["hs_jacobi"])

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
            b, by = bound_ms(*kernel_costs(n, n)["lk_build"])
            emit(kernel="lk_build", shape=list(shape), shifts=121, event_ms=k, plain_event_ms=p,
                 device_ms=device_ms(kernel, 10 if n <= 1024 else 3), host_ms=host_ms(kernel, reps),
                 bound_ms=b, bound_by=by)
            del slab, g_pair
            torch.cuda.empty_cache()
    print(gpu)


if __name__ == "__main__":
    main()
