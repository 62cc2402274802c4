#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opticalflow_ri_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's Horn-Schunck pyramidal main path on the card, in phases:

  1. device  — requires CUDA (no CPU fallback); prints the card's name and
               power limit, torch, CUDA and nvcc versions;
  2. build   — builds every kernel from csrc/ with nvcc;
  3. parity  — each kernel against its plain PyTorch version on the same
               CUDA tensors (HS Jacobi at 512^2, 333x517 and 2048^2; the pair
               warp at 512^2 and 333x517 on calibrated and wild flows);
  4. main    — the five HS configurations and the README's wrapper call on a
               512^2 synthetic pair, launch counters reset just before; flows
               held against the port's plain path on the CPU (AEE <= 5e-6) and
               the 96^2 golden flows (AEE < 1e-3);
  5. times   — CUDA-event medians, kernel path against plain PyTorch on the
               card, per configuration and per kernel at 512^2 and 2048^2.

Any failure raises, so the exit code is non-zero and no result line is
printed.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches, error and times.  Imports no
JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(ROOT, "opticalflow_ri_tpu_torch")
GOLDEN = os.path.join(ROOT, "tests", "golden", "synthetic96_flows.npz")

HS_BAR = 1e-5          # absolute, the bar of tests/test_pallas_kernels.py
WARP_BAR_REL = 1e-5    # relative to the image's range
AEE_BAR = 5e-6         # card against the CPU plain path, whole pipeline
GOLDEN_BAR = 1e-3      # tests/test_golden.py
REPS = 15


def phase(name: str) -> None:
    print(f"# phase {name}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def aee(u, v, u_ref, v_ref) -> float:
    return float(np.mean(np.hypot(u - u_ref, v - v_ref)))


def to_np(t):
    return t.detach().cpu().numpy()


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
        GenericPyramidalOpticalFlowWrapper, HSOpticalFlowAlgoAdapter,
        generic_pyramidal_optical_flow,
    )
    from opticalflow_ri_tpu_torch.configs import run_config
    from opticalflow_ri_tpu_torch.ops.cuda import build, hs_iter, warp_tent
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

    err = {"hs_jacobi": 0.0, "warp_pair": 0.0}
    for shape in [(512, 512), (333, 517), (2048, 2048)]:
        fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
        u0, v0 = rand(shape, -2, 2), rand(shape, -2, 2)
        got = hs_iter.hs_iterate(fx, fy, ft, u0, v0, 21.0, 100)
        want = hs_iter.hs_iterate_plain(fx, fy, ft, u0, v0, 21.0, 100)
        torch.cuda.synchronize()
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"hs_jacobi {shape} niter=100: max|d|={d!r} (bar {HS_BAR}) bitwise={same}")
        if not d <= HS_BAR:
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

    hs_iter.hs_iterate.launches = 0
    warp_tent.warp_pair.launches = 0
    flows, counts = {}, {}
    for name, fn in runs.items():
        before = (hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches)
        flows[name] = fn(g1, g2)
        counts[name] = (hs_iter.hs_iterate.launches - before[0],
                        warp_tent.warp_pair.launches - before[1])
    torch.cuda.synchronize()
    launches = {"hs_jacobi": hs_iter.hs_iterate.launches,
                "warp_pair": warp_tent.warp_pair.launches}
    print(f"main-path launches: {launches}")

    for name, (u, v) in flows.items():
        n_hs, n_warp = counts[name]
        if u.device != dev or u.shape != (512, 512) or u.dtype != torch.float32:
            raise AssertionError(f"{name}: flow {u.dtype} {tuple(u.shape)} on {u.device}")
        if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())):
            raise AssertionError(f"{name}: non-finite flow")
        if n_hs < 1:
            raise AssertionError(f"{name}: the HS kernel was not launched")
        if name.endswith("PyrLvls2") and n_warp < 1:
            raise AssertionError(f"{name}: the warp kernel was not launched")
        ref = runs[name](c1, c2)
        e = aee(to_np(u), to_np(v), to_np(ref[0]), to_np(ref[1]))
        print(f"{name}: hs launches {n_hs}, warp launches {n_warp}, "
              f"AEE vs CPU plain path {e!r} (bar {AEE_BAR})")
        if not e <= AEE_BAR:
            raise AssertionError(f"{name}: card and CPU disagree")

    golden = np.load(GOLDEN)
    s1, s2, _, _ = particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)
    u, v = generic_pyramidal_optical_flow(
        s1, s2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1, device=dev)
    e = aee(to_np(u), to_np(v), golden["hs_u"], golden["hs_v"])
    print(f"golden 96x96 2-level HS on {u.device}: AEE {e!r} (bar {GOLDEN_BAR})")
    if not e < GOLDEN_BAR:
        raise AssertionError("golden flows disagree")

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
        saved = hs_iter.hs_iterate, warp_tent.warp_pair
        hs_iter.hs_iterate, warp_tent.warp_pair = hs_iter.hs_iterate_plain, warp_tent.warp_pair_plain
        try:
            yield
        finally:
            hs_iter.hs_iterate, warp_tent.warp_pair = saved

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

    saved_counts = hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches
    config_times = {}
    for name, fn in runs.items():
        k, p = ab(lambda: fn(g1, g2), lambda: fn(g1, g2))
        config_times[name] = (k, p)
        print(json.dumps({"config": name, "shape": [512, 512], "kernel_ms": k, "plain_ms": p,
                          "gpu": gpu}))

    kernel_times = {}
    for shape in [(512, 512), (2048, 2048)]:
        fx, fy, ft = hs_derivatives(rand(shape, 0, 255), rand(shape, 0, 255))
        z = torch.zeros(shape, device=dev)
        k, p = ab(lambda: hs_iter.hs_iterate(fx, fy, ft, z, z, 1.0, 100),
                  lambda: hs_iter.hs_iterate_plain(fx, fy, ft, z, z, 1.0, 100))
        kernel_times[("hs_jacobi", shape)] = (k, p)
        print(json.dumps({"kernel": "hs_jacobi", "shape": list(shape), "niter": 100,
                          "kernel_ms": k, "plain_ms": p, "gpu": gpu}))
        args = [rand(shape, 0, 255), rand(shape, 0, 255)]
        args += [rand(shape, -4, 4) for _ in range(4)]
        k, p = ab(lambda: warp_tent.warp_pair(*args), lambda: warp_tent.warp_pair_plain(*args))
        kernel_times[("warp_pair", shape)] = (k, p)
        print(json.dumps({"kernel": "warp_pair", "shape": list(shape), "flow": "|d|<=4",
                          "kernel_ms": k, "plain_ms": p, "gpu": gpu}))
    hs_iter.hs_iterate.launches, warp_tent.warp_pair.launches = saved_counts

    # ---------------------------------------------------------------- result
    kernels = [
        {"name": "hs_jacobi", "route": "cuda",
         "source": "opticalflow_ri_tpu_torch/csrc/hs_jacobi.cu",
         "replaces": "opticalflow_ri_tpu/ops/pallas/hs_iter.py:113",
         "also_replaces": ["opticalflow_ri_tpu/ops/pallas/hs_tiled.py:164"],
         "launches": launches["hs_jacobi"], "max_abs_err": err["hs_jacobi"],
         "ms": kernel_times[("hs_jacobi", (512, 512))][0],
         "plain_ms": kernel_times[("hs_jacobi", (512, 512))][1]},
        {"name": "warp_pair", "route": "cuda",
         "source": "opticalflow_ri_tpu_torch/csrc/warp_pair.cu",
         "replaces": "opticalflow_ri_tpu/ops/pallas/warp_tent.py:120",
         "launches": launches["warp_pair"], "max_abs_err": err["warp_pair"],
         "ms": kernel_times[("warp_pair", (512, 512))][0],
         "plain_ms": kernel_times[("warp_pair", (512, 512))][1]},
    ]
    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was never launched by the main path")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
