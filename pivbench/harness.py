"""One run of one cell: the pool from the seed, the warm-up, the window
(timed, or traced), the comparison with the reference, the result line.

``run_cell`` does not look for a card: ``run.py`` does, and the tests drive
the rest of a run on the CPU at a small size.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from pivbench import check, spec, work
from pivbench.drive import Driver
from pivbench.generator import make_pool
from pivbench.trace import breakdown, busy_ns, clip, matches, profiled


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p95(values: list) -> float:
    return float(np.percentile(np.asarray(values), 95))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """The result of one run (the keys the result line prints).  ``t_process``
    is the process's start on ``time.time()``'s clock."""
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    t_pool = time.time()
    a, b, _ = make_pool(cfg, seed, int(traffic["pool"]), dev)
    im1s, im2s = a.cpu().numpy(), b.cpu().numpy()
    t_warm = time.time()
    del a, b
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    driver = Driver(traffic, cfg["registry"], im1s, im2s, dev)
    rate = driver.warm_up()
    _sync(dev)
    setup_s = time.time() - t_process
    parts = {"to_pool_s": t_pool - t_process, "pool_s": t_warm - t_pool,
             "warm_up_s": t_process + setup_s - t_warm}

    tr = plain = None
    if trace:
        calls = int(traffic["trace_calls"])
        # the same calls untraced first: the entry's host time, without the
        # profiler's own cost on the host
        plain = driver.run(0, seed, rate, calls=calls)
        with profiled(dev) as tr:
            driver.call(0)      # the profiler's own first-call costs, before the window
            window = driver.run(0, seed, rate, calls=calls, traced=True)
            _sync(dev)
    else:
        window = driver.run(seconds, seed, rate)
    dinfo = device_info(dev, cell.chips)
    driver.release()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    flows = {}
    for c in window.kept.values():
        for j, i in enumerate(c.pairs):
            flows[i] = (c.u[j], c.v[j])
    pool = range(im1s.shape[0])
    t_ref = time.time()
    numbers = check.compare(flows, check.reference_flows(cfg, im1s, im2s, pool, dev))
    correct, checks = check.verdict(cfg, numbers, len(flows))
    failed = 0 if correct else sum(len(c.pairs) for c in window.kept.values())

    result = {"correct": correct, "attempted": window.pairs, "failed": failed}
    if trace:
        ctx = context(cell, tr, window, numbers["tally"], plain)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dev.type == "cuda":
            result["trace_faults"] = trace_faults(cell, ctx, metrics)
        lo, hi = tr.window()
        dinfo["busy_s"] = ctx["busy_ns"] / 1e9
        dinfo["window_s"] = (hi - lo) / 1e9
        result.update(metrics=metrics, device=dinfo, breakdown=breakdown(tr),
                      trace_check=ctx["trace_check"])
    else:
        e2e = {"pairs_per_s": window.pairs / (window.end - window.start),
               "pair_ms_p95": 1e3 * p95(window.latencies),
               "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=dinfo)
    result["setup_parts"] = parts
    result["reference_s"] = time.time() - t_ref
    result["checks"] = checks
    return result


EXTENT_SHARE = 0.02     # CUDA events against the trace's end, as a share of the events


def trace_faults(cell: spec.Cell, ctx: dict, metrics: dict) -> list:
    """Why the trace cannot be read, if it cannot: the loop by CUDA events
    and the trace's device timeline, from the loop's start to its last
    device operation, differ by more than ``EXTENT_SHARE`` of the events;
    a call of the window holds no kernel of a stage that a metric of the
    cell reads; or a metric that names the cell among its ``workloads``
    found nothing to read."""
    faults = []
    tc = ctx["trace_check"]
    gap = abs(tc["event_ms"] - tc["profiler_extent_ms"])
    if gap > EXTENT_SHARE * tc["event_ms"]:
        faults.append(f"the loop took {tc['event_ms']:.4f} ms by CUDA events and "
                      f"{tc['profiler_extent_ms']:.4f} ms to the trace's last device op")
    entries = sorted((s, e) for n, s, e in ctx["trace"].spans if n == "entry")
    fetches = sorted((s, e) for n, s, e in ctx["trace"].spans if n == "fetch")
    kernels = [o for o in ctx["ops"] if o.kind == "kernel"]
    for m in cell.per_layer:
        stage = getattr(spec.module(m["name"], cell.root), "STAGE", None)
        names = ctx["stages"].get(stage, [])
        for i, ((lo, _), (_, hi)) in enumerate(zip(entries, fetches)):
            if stage and not any(lo <= o.start < hi and any(matches(o.name, k) for k in names)
                                 for o in kernels):
                faults.append(f"call {i} of the window holds no kernel of stage {stage} "
                              f"({m['name']})")
                break
        if "workloads" in m and m["name"] not in metrics:
            faults.append(f"{m['name']} found nothing to read")
    if not entries or len(entries) != len(fetches):
        faults.append(f"{len(entries)} entry spans and {len(fetches)} fetch spans in the trace")
    return faults


def context(cell: spec.Cell, tr, window, tally: dict, plain=None) -> dict:
    """What a per-layer reader reads: the trace, the window's pairs and the
    reference's tally of their work, the stages' kernel names, and
    ``plain``, the same calls untraced (a ``Window``)."""
    lo, hi = tr.window()
    ops = [o for o in tr.ops if o.end > lo and o.start < hi]
    busy = busy_ns(clip([(o.start, o.end) for o in ops], lo, hi))
    entries = [e for i, n in window.visits.items() for e in tally.get(i, []) for _ in range(n)]
    stages = spec.stages(cell.root)
    hand = {k for names in stages.values() for k in names}
    ctx = {"trace": tr, "window": (lo, hi), "ops": ops, "busy_ns": busy, "pairs": window.pairs,
           "entries": entries, "stages": stages, "hand_kernels": hand, "work": work,
           "plain": plain}
    ctx["trace_check"] = {
        "event_ms": window.event_ms,
        "profiler_extent_ms": (max(o.end for o in ops) - lo) / 1e6 if ops else 0.0,
        "profiler_busy_ms": busy / 1e6, "device_ops": len(ops),
        "profiler_slowdown": ((hi - lo) / 1e9 / (plain.end - plain.start)
                              if plain and plain.end > plain.start else None)}
    return ctx
