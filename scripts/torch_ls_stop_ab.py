#!/usr/bin/env python3
"""The eager sharded Liu-Shen of two trees side by side, four gloo ranks on one card.

    python3 scripts/torch_ls_stop_ab.py --parent DIR [--size 512] [--reps 5]
        [--device cuda|cpu]

DIR holds a checkout of the commit to compare with (``git archive`` of it,
unpacked); this tree is the other side.  For each tree in the order parent,
tree, tree, parent the script spawns a group of four gloo ranks (one process
each, all on the one card, as ``tests/test_torch_cuda_gloo.py`` spawns) that
import the port from that tree.  Rank 0 times, at ``--size``² on
``particle_image_pair(seed=0)``:

- every LiuSE configuration, eagerly on (1, 2, 2) tiles: the tree's
  ``parallel.auto.sharded_pipeline_fn``, or ``auto_sharded_pipeline`` where
  the tree has no ``sharded_pipeline_fn`` (it ran eagerly there);
- ``liu_shen_solve_sharded_kernel`` on (1, 4, 1) stripes, h 10, 60 steps,
  with ``tol`` 0 (every block runs), the err after the first block (the
  stop after it) and 1e9 (no block runs).

Each call starts after a barrier; rank 0 reports CUDA-event ms and host ms,
medians of ``--reps`` after one warm-up, the sha256 of its (u, v) tiles
(the trees must agree bit for bit) and, where the tree counts them
(``liu_shen_solve_sharded_kernel.err_reads``, one host read of err a block
run), the blocks run per call, and K4/K5's launches per call (its wrapper's
count: a block enqueued, run or gated, launches it).  The kernels of each
tree are built once before its first group.  Output: one JSON line per
group, then the A/B summary, also written to ``chiprun_out/ls_stop_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
RANK_TIMEOUT_S = 600


def _rank(args) -> None:
    """One rank of a group: ``--rank R --tree DIR --init URL --out FILE``."""
    sys.path.insert(0, args.tree)
    import hashlib

    import torch

    from opticalflow_ri_tpu_torch.configs import CONFIGS
    from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter
    from opticalflow_ri_tpu_torch.parallel import auto, distributed, make_mesh
    from opticalflow_ri_tpu_torch.parallel import sharded_kernel as sk
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

    cuda = args.device == "cuda"
    distributed.initialize(args.init, WORLD, args.rank, backend="gloo",
                           **({} if cuda else {"device": "cpu"}))
    kw = {} if cuda else {"device_type": "cpu"}
    m22, m41 = make_mesh(shape=(1, 2, 2), **kw), make_mesh(shape=(1, 4, 1), **kw)
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    shape = (args.size, args.size)
    pair = [torch.as_tensor(im, device=dev) for im in particle_image_pair(shape, seed=0)[:2]]
    yx, rows = ("y", "x"), ("y", None)
    tiles = [im[distributed.local_slices(m22, shape, yx)].contiguous() for im in pair]
    stripes = [im[distributed.local_slices(m41, shape, rows)].contiguous() for im in pair]
    zero = torch.zeros_like(stripes[0])
    eager = getattr(auto, "sharded_pipeline_fn", None) or auto.auto_sharded_pipeline

    def reads():
        return getattr(sk.liu_shen_solve_sharded_kernel, "err_reads", None)

    def launches():   # K4/K5's wrapper count (0 on CPU tiles, which run its plain version)
        return liu_shen_iter.liu_shen_iterate.launches

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def one(call):
        torch.distributed.barrier()
        sync()
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = call()
        host = 1e3 * (time.perf_counter() - t0)
        if cuda:
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end), host
        return out, None, host

    def timed(call):
        before, launched = reads(), launches()
        out = one(call)[0]   # warm-up
        blocks = None if before is None else reads() - before
        launched = launches() - launched
        runs = [one(call)[1:] for _ in range(args.reps)]
        digest = hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in out[:2]))
        return {"event_ms": statistics.median(r[0] for r in runs) if cuda else None,
                "host_ms": statistics.median(r[1] for r in runs), "blocks": blocks,
                "liu_shen_launches": launched,
                "sha256": digest.hexdigest()}

    times = {}
    for name in (n for n in CONFIGS if n.startswith("LiuSE")):
        fn = eager(name, m22)
        times[name] = timed(lambda: fn(*tiles))
    solve = lambda tol: sk.liu_shen_solve_sharded_kernel(  # noqa: E731
        m41, *stripes, 10.0, zero, zero, max_iter=60, tol=tol)
    t = sk.pick_ls_shard_t(m41, shape)
    first = sk.liu_shen_solve_sharded_kernel(m41, *stripes, 10.0, zero, zero, max_iter=t,
                                             tol=0.0)[2]
    stops = {"tol 0 (every block)": 0.0, "tol = err after block 1": float(first),
             "tol 1e9 (no block)": 1e9}
    for label, tol in stops.items():
        times[f"liu_shen_solve_sharded_kernel, {label}"] = timed(lambda: solve(tol))
    if args.rank == 0:
        with open(args.out, "w") as f:
            json.dump({"times": times, "t_block": t, "steps": 60,
                       "eager_entry": eager.__name__}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _build(tree: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                             "from opticalflow_ri_tpu_torch.ops.cuda import build; build.build()",
                             tree])


def _group(args, tree: str, work: str, k: int) -> dict:
    rdv = os.path.join(work, f"rendezvous_{k}")
    out = os.path.join(work, f"group_{k}.json")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("LOCAL_RANK", "RANK", "WORLD_SIZE"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--tree", tree,
         "--init", f"file://{rdv}", "--out", out, "--size", str(args.size),
         "--reps", str(args.reps), "--device", args.device], env=env, cwd=tree)
        for r in range(WORLD)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit(f"torch_ls_stop_ab: a rank of the group on {tree} failed: "
                         f"{[p.returncode for p in procs]}")
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="a checkout of the commit to compare with")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args)
        return
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    gpu = "cpu"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_ls_stop_ab: no CUDA device (use --device cpu to rehearse)")
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        builds = [_build(tree) for tree in (parent, ROOT)]
        if any(b.wait() != 0 for b in builds):
            raise SystemExit("torch_ls_stop_ab: a kernel build failed")
    order = [("parent", parent), ("tree", ROOT), ("tree", ROOT), ("parent", parent)]
    runs = []
    with tempfile.TemporaryDirectory(prefix="ofri_ls_ab_") as work:
        for k, (side, tree) in enumerate(order):
            rec = {"side": side, **_group(args, tree, work, k)}
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    summary = {}
    for label in runs[0]["times"]:
        per = [r["times"][label] for r in runs]
        summary[label] = {
            "event_ms": [p["event_ms"] for p in per], "host_ms": [p["host_ms"] for p in per],
            "parent_blocks": per[0]["blocks"],
            "liu_shen_launches": [p["liu_shen_launches"] for p in per],
            "bitwise": len({p["sha256"] for p in per}) == 1}
    result = {"ls_stop_ab": summary, "order": [s for s, _ in order], "size": args.size,
              "reps": args.reps, "ranks": f"{WORLD} gloo ranks sharing one {args.device}",
              "gpu": gpu}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ls_stop_ab.json"), "w") as f:
        json.dump({"runs": runs, **result}, f, indent=1)
    print(json.dumps(result), flush=True)
    if not all(s["bitwise"] for s in summary.values()):
        raise SystemExit("torch_ls_stop_ab: the trees' flows differ")


if __name__ == "__main__":
    main()
