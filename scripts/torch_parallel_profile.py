#!/usr/bin/env python3
"""Host cost of the port's sharded solves on one rank (opticalflow_ri_tpu_torch.parallel).

    python3 scripts/torch_parallel_profile.py [--size 2048] [--calls 5] [--device cuda]
        [--profile hs|lk|fb]

Joins a one-rank process group (NCCL on the card; gloo with ``--device cpu``),
then, at ``--size``² on ``particle_image_pair(seed=0)``, times the sharded
HS_Fs3_4 (route 1 run eagerly, ``sharded_pipeline_fn``, on the one-rank mesh),
the sharded Liu-Shen solve (h 10, 60 steps, tol 0), the rows-sharded dense
LK (``lk_solve_sharded_kernel``, half window 13, 5 steps) and Farneback
(``farneback_solve_sharded``, window 33, 5 iterations, one level), each
beside its eager single-device call: CUDA-event ms and the host's ms in the
call, medians of ``--calls``, and per sharded call its halo exchanges and
kernel launches.  Then it profiles ``--calls`` calls of the sharded solve
``--profile`` names with cProfile and prints the functions with the most
own host time.  The full cProfile listing goes to
``chiprun_out/parallel_profile.txt``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--profile", default="hs", choices=("hs", "lk", "fb"))
    args = ap.parse_args()

    import torch

    from opticalflow_ri_tpu_torch.configs import run_config
    from opticalflow_ri_tpu_torch.models.farneback import farneback_solve
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_solve
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve
    from opticalflow_ri_tpu_torch.ops.cuda import (
        blur5_flow, hs_iter, liu_shen_iter, lk_build, lk_iter, tent_sample,
    )
    from opticalflow_ri_tpu_torch.parallel import (
        distributed, exchange_halo, farneback_solve_sharded, liu_shen_solve_sharded,
        lk_solve_sharded_kernel, make_mesh,
    )
    from opticalflow_ri_tpu_torch.parallel.auto import sharded_pipeline_fn
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_parallel_profile: no CUDA device (use --device cpu to rehearse)")
    rdv = os.path.join(tempfile.mkdtemp(prefix="ofri_rdv_"), "rendezvous")
    distributed.initialize(f"file://{rdv}", 1, 0, device=args.device)
    mesh = make_mesh(device_type=args.device)
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    pair = [torch.as_tensor(im, device=dev)
            for im in particle_image_pair((args.size, args.size), seed=0)[:2]]
    zero = torch.zeros_like(pair[0])
    sharded_hs = sharded_pipeline_fn("HS_Fs3_4", mesh)
    calls = {
        "sharded HS_Fs3_4": lambda: sharded_hs(*pair),
        "eager HS_Fs3_4": lambda: run_config("HS_Fs3_4", *pair),
        "sharded Liu-Shen": lambda: liu_shen_solve_sharded(mesh, *pair, 10.0, zero, zero,
                                                           max_iter=60, tol=0.0),
        "eager Liu-Shen": lambda: liu_shen_solve(*pair, 10.0, zero, zero, 60, 0.0),
        "sharded LK": lambda: lk_solve_sharded_kernel(mesh, *pair, zero, zero),
        "eager LK": lambda: lk_dense_solve(*pair, zero, zero),
        "sharded FB": lambda: farneback_solve_sharded(mesh, *pair, zero, zero),
        "eager FB": lambda: farneback_solve(*pair, zero, zero),
    }
    profiled = {"hs": "sharded HS_Fs3_4", "lk": "sharded LK", "fb": "sharded FB"}[args.profile]
    counters = {"halo_exchanges": exchange_halo, "hs_iterate": hs_iter.hs_iterate,
                "liu_shen_iterate": liu_shen_iter.liu_shen_iterate,
                "lk_build_planes": lk_build.lk_build_planes, "lk_gn_iterate": lk_iter.lk_gn_iterate,
                "update_matrices": tent_sample.update_matrices,
                "blur5_flow": blur5_flow.blur5_flow}

    def counts():
        return {k: getattr(f, "exchanges" if k == "halo_exchanges" else "launches")
                for k, f in counters.items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def one(call):
        sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        call()
        host = 1e3 * (time.perf_counter() - t0)
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end), host
        return None, host

    gpu = "cpu"
    if cuda:
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    times = {}
    for label, call in calls.items():
        before = counts()
        call()  # warm-up, counted
        used = {k: v - before[k] for k, v in counts().items() if v - before[k]}
        runs = [one(call) for _ in range(args.calls)]
        times[label] = {"event_ms": (statistics.median(r[0] for r in runs) if cuda else None),
                        "host_ms": statistics.median(r[1] for r in runs)}
        if label.startswith("sharded"):
            times[label]["per_call"] = used
    print(json.dumps({"size": args.size, "calls": args.calls, "times": times, "gpu": gpu}),
          flush=True)

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.calls):
        calls[profiled]()
    sync()
    prof.disable()
    for key, n in (("tottime", 25), ("cumulative", 40)):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(n)
        text = out.getvalue()
        if key == "tottime":
            print(text, flush=True)
        else:
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "parallel_profile.txt"), "w") as f:
                f.write(text)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
