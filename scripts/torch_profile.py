#!/usr/bin/env python3
"""Device time and idle share of the PyTorch/CUDA port on one GPU.

    python3 scripts/torch_profile.py [--out chiprun_out/torch_profile.json]

For each named configuration on the 512^2 synthetic pair
(``particle_image_pair(shape=(512, 512), seed=0)``), for each dense-LK
kernel at 512^2 and 2048^2 (half window 13, R = 5, 5 GN steps) and for each
Farneback kernel there (R = 5, window 33 Gaussian, 5 iterations for the fused
loop), kernel and plain version, it reports:

  * wall_ms   — host clock around one call ended by ``torch.cuda.synchronize()``,
                mean of ``--reps`` calls after a warm-up, unprofiled;
  * device_ms — the sum of the device-side entries (kernels, copies) of
                ``torch.profiler`` over ``--reps`` calls, per call;
  * idle      — 1 - device_ms / wall_ms, the share of the call the card waits
                for the host;
  * top       — the five largest device-time entries by name.

It prints one JSON line per row and writes all rows to ``--out``.  Needs a
CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from opticalflow_ri_tpu_torch.configs import run_config  # noqa: E402
from opticalflow_ri_tpu_torch.models.farneback import _window_blur_spec, poly_expansion  # noqa: E402
from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_kernel_inputs  # noqa: E402
from opticalflow_ri_tpu_torch.ops.cuda import (  # noqa: E402
    blur5_flow, fb_fused, lk_build, lk_iter, tent_sample,
)
from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair  # noqa: E402

CONFIGS = ("denseLK_Fs2_0", "denseLK_Fs2_0_PyrLvls2", "LiuSE_denseLK_Fs2_0_PyrLvls2",
           "LK_Fs2_0", "LK_Fs2_0_PyrLvls2", "HS_Fs3_4_PyrLvls2", "LiuSE_HS_Fs3_4_PyrLvls2",
           "Farneback_Fs0_0", "Farneback_Fs0_0_PyrLvls2", "LiuSE_Farneback_Fs0_0_PyrLvls2",
           "FB_Fs0_0", "FB_Fs0_0_PyrLvls2")


def wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps: int):
    """Per-call device time and the five largest entries, from the profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side entries only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), [{"name": k[:80], "ms": t, "calls": c} for k, t, c in rows[:5]]


def measure(label: str, fn, reps: int, gpu: str, **extra) -> dict:
    wall = wall_ms(fn, reps)
    dev, top = device_ms(fn, reps)
    row = {"what": label, **extra, "wall_ms": wall, "device_ms": dev,
           "idle": 1.0 - dev / wall, "top": top, "gpu": gpu}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "torch_profile.json"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    rows = []

    im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)
    g1, g2 = torch.as_tensor(im1, device=dev), torch.as_tensor(im2, device=dev)
    for name in args.configs:
        rows.append(measure(name, lambda n=name: run_config(n, g1, g2), args.reps, gpu,
                            shape=[512, 512]))

    rng = np.random.default_rng(0)
    for shape in [(512, 512), (2048, 2048)]:
        a = rng.uniform(0, 255, shape).astype(np.float32)
        b = np.roll(a, (1, 2), axis=(0, 1)) + rng.normal(0, 2, shape).astype(np.float32)
        u0, v0 = (torch.as_tensor(rng.uniform(-4, 4, shape).astype(np.float32), device=dev)
                  for _ in range(2))
        slab, g_pair, fields, ry, rx = lk_kernel_inputs(
            torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev), u0, v0)
        reps = args.reps if shape == (512, 512) else 3
        t1, t2 = lk_build.lk_build_planes(slab, g_pair, 13, 5, ry, rx)
        calls = {
            "lk_build": lambda: lk_build.lk_build_planes(slab, g_pair, 13, 5, ry, rx),
            "lk_build_plain": lambda: lk_build.lk_build_planes_plain(slab, g_pair, 13, 5, ry, rx),
            "lk_gn": lambda: lk_iter.lk_gn_iterate(t1, t2, *fields, 5, 5, 13),
            "lk_gn_plain": lambda: lk_iter.lk_gn_iterate_plain(t1, t2, *fields, 5, 5, 13),
            "lk_fused": lambda: lk_iter.lk_fused(slab, g_pair, *fields, 5, 5, 13, ry, rx),
            "lk_fused_plain": lambda: lk_iter.lk_fused_plain(slab, g_pair, *fields, 5, 5, 13,
                                                             ry, rx),
        }
        for label, fn in calls.items():
            rows.append(measure(label, fn, reps, gpu, shape=list(shape)))
        del t1, t2, slab, g_pair, fields

        p1, p2, _, _ = particle_image_pair(shape=shape, seed=0)
        r0, r1 = (poly_expansion(torch.as_tensor(im, device=dev), 7, 1.5).contiguous()
                  for im in (p1, p2))
        z = torch.zeros(shape, dtype=torch.float32, device=dev)
        m = tent_sample.update_matrices(z, z, r0, r1)
        taps, mode, scale = _window_blur_spec(33, True)
        calls = {
            "fb_update_matrices": lambda: tent_sample.update_matrices(u0, v0, r0, r1),
            "fb_update_matrices_plain":
                lambda: tent_sample.update_matrices_plain(u0, v0, r0, r1),
            "fb_blur5_flow": lambda: blur5_flow.blur5_flow(m, taps, mode, scale),
            "fb_blur5_flow_plain": lambda: blur5_flow.blur5_flow_plain(m, taps, mode, scale),
            "fb_fused": lambda: fb_fused.fb_fused(r0, r1, z, z, 5, taps, mode, scale),
            "fb_fused_plain": lambda: fb_fused.fb_fused_plain(r0, r1, z, z, 5, taps, mode, scale),
        }
        for label, fn in calls.items():
            rows.append(measure(label, fn, reps, gpu, shape=list(shape)))
        del r0, r1, m
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
