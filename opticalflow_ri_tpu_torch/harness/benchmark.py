"""Benchmark grid (port of ``harness/benchmark.py``, ref:
benchmark_of_methods.py).

Runs the Horn-Schunck / Lucas-Kanade / Farneback configuration grid on one
image pair through ``compile.compiled_pipeline``, times each, and writes the
flow ``.mat`` files and ``benchmark_summary.txt``; with ``plots=True`` also
the colormesh + quiver plots and the time chart, which need matplotlib.
On the card a config's time is CUDA events around one call after a warm-up
call that captures its graph; on the CPU it is the host clock.

    python3 -m opticalflow_ri_tpu_torch.harness.benchmark --im1 a.tif --im2 b.tif --no-plots
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from opticalflow_ri_tpu_torch.utils.device import resolve
from opticalflow_ri_tpu_torch.utils.io import normalize_16bit_to_8bit, save_flow

# The configuration grid of the reference harness
# (ref: benchmark_of_methods.py:143-148, :197-201, :251-255)
BENCH_CONFIG_NAMES = [
    "HS_Fs0_0", "HS_Fs3_4", "HS_Fs3_4_PyrLvls2", "LiuSE_HS_Fs3_4_PyrLvls2",
    "LK_Fs2_0", "LK_Fs2_0_PyrLvls2", "LiuSE_LK_Fs2_0_PyrLvls2",
    "FB_Fs0_0", "FB_Fs0_0_PyrLvls2", "LiuSE_FB_Fs0_0_PyrLvls2",
]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plots=True needs matplotlib, which is not installed; "
                           "pass plots=False (--no-plots)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_results(u, v, title, output_base, quiver_skip=40, quiver_scale=50):
    """Colormesh + quiver plots (ref: benchmark_of_methods.py:57-108)."""
    plt = _pyplot()
    from matplotlib.colors import Normalize

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8))
    vmax = max(abs(np.percentile(v, 1)), abs(np.percentile(v, 99)))
    im = ax1.imshow(v, cmap="jet", norm=Normalize(vmin=-vmax, vmax=vmax))
    ax1.set_title(f"{title} - Vertical Velocity (v)")
    plt.colorbar(im, ax=ax1, label="Pixels/frame")

    y, x = np.mgrid[0 : u.shape[0] : quiver_skip, 0 : u.shape[1] : quiver_skip]
    us = u[::quiver_skip, ::quiver_skip]
    vs = v[::quiver_skip, ::quiver_skip]
    mag = np.hypot(us, vs)
    q = ax2.quiver(x, y, us, vs, mag, scale=quiver_scale, scale_units="inches",
                   cmap="jet", clim=[0, np.percentile(mag, 95)])
    plt.colorbar(q, ax=ax2, label="Magnitude (pixels/frame)")
    ax2.set_title(f"{title} - Vector Field")
    ax2.set_xlim(0, u.shape[1])
    ax2.set_ylim(u.shape[0], 0)
    plt.tight_layout()
    plt.savefig(f"{output_base}.png", dpi=200)
    plt.close(fig)


def _timed(fn, im1, im2, dev: torch.device):
    """(u, v, seconds) of one call: CUDA events on the card, else the host
    clock."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        u, v = fn(im1, im2, device=dev)
        return u, v, time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    u, v = fn(im1, im2, device=dev)
    end.record()
    end.synchronize()
    return u, v, start.elapsed_time(end) / 1e3


def run_benchmark(img1, img2, output_dir="benchmark_results", configs=None, plots=True,
                  device="cuda"):
    """Run the benchmark grid; returns {name: {U, V, time}} with U, V numpy
    arrays and time in seconds.  A config that fails is reported and
    skipped, like the reference."""
    from opticalflow_ri_tpu_torch.compile import compiled_pipeline

    if plots:
        _pyplot()  # fail before the runs, not after them
    dev = resolve(device)
    os.makedirs(output_dir, exist_ok=True)
    img1 = normalize_16bit_to_8bit(np.asarray(img1, np.float32))
    img2 = normalize_16bit_to_8bit(np.asarray(img2, np.float32))
    im1 = torch.as_tensor(img1, device=dev)
    im2 = torch.as_tensor(img2, device=dev)

    results = {}
    for name in configs or BENCH_CONFIG_NAMES:
        try:
            fn = compiled_pipeline(name)
            try:
                fn(im1, im2, device=dev)  # warm-up: on the card, the capture
                u, v, elapsed = _timed(fn, im1, im2, dev)
                u, v = u.cpu().numpy(), v.cpu().numpy()
            finally:
                fn.release()
            results[name] = {"U": u, "V": v, "time": elapsed}
            save_flow(u, v, os.path.join(output_dir, f"{name}.mat"))
            if plots:
                plot_results(u, v, name, os.path.join(output_dir, name))
        except Exception as e:  # per-config isolation, like the reference
            print(f"  Error running {name}: {e!r}")

    _write_summary(results, output_dir)
    if plots and results:
        _plot_times(results, output_dir)
    return results


def _write_summary(results, output_dir):
    with open(os.path.join(output_dir, "benchmark_summary.txt"), "w") as f:
        f.write("Optical Flow Methods Benchmark Summary\n")
        f.write("=====================================\n\n")
        f.write(f"{'Method':<30} {'Time (s)':<10} {'U min/max':<20} {'V min/max':<20}\n")
        f.write("-" * 80 + "\n")
        for name, r in results.items():
            u_range = f"{r['U'].min():.2f}/{r['U'].max():.2f}"
            v_range = f"{r['V'].min():.2f}/{r['V'].max():.2f}"
            f.write(f"{name:<30} {r['time']:<10.4f} {u_range:<20} {v_range:<20}\n")


def _plot_times(results, output_dir):
    plt = _pyplot()
    names = list(results)
    times = [results[n]["time"] for n in names]
    plt.figure(figsize=(12, 6))
    plt.bar(names, times)
    plt.ylabel("Execution Time (seconds)")
    plt.title("Optical Flow Methods - Execution Time Comparison")
    plt.xticks(rotation=45, ha="right")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "execution_time_comparison.png"), dpi=150)
    plt.close()


def main():
    import argparse

    from opticalflow_ri_tpu_torch.utils.io import load_image

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--im1", required=True)
    ap.add_argument("--im2", required=True)
    ap.add_argument("--out", default="benchmark_results")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    results = run_benchmark(load_image(args.im1), load_image(args.im2), args.out,
                            plots=not args.no_plots, device=args.device)
    for name, r in results.items():
        print(f"{name:<30} {r['time']:.4f}s  U[{r['U'].min():.2f},{r['U'].max():.2f}]")


if __name__ == "__main__":
    main()
