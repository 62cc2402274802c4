"""The port's multi-GPU layer on four gloo ranks sharing the one card.

Marked ``cuda``; the test skips without a CUDA device (decided in the test,
never at import).  Run on the machine with the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_gloo.py -q

The test spawns four ranks of this file (``python tests/test_torch_cuda_gloo.py
RANK WORLD INIT WORK``): a gloo group on the one card, its halos staged
through host memory.  On ``particle_image_pair(seed=0)`` at 2048^2 the ranks
run the kernel-sharded HS solve ((1, 2, 2) tiles), the rows-sharded
Liu-Shen, dense LK and Farneback solves ((1, 4, 1) stripes),
``batched_hs_pipeline`` ((2, 1, 2), two pairs) and route 1
(``sharded_pipeline_fn("HS_Fs3_4")``); rank 0 gathers the tiles and holds
them against the single-device port bit for bit (err to 1e-6 relative),
each path launching its kernels.  ``auto_sharded_pipeline`` refuses their
CUDA tiles, naming ``sharded_pipeline_fn``.  Route 2, the sharded pyramid,
runs every configuration but the single-level HS ones at 512^2 and one a
solver at 2048^2 on (1, 2, 2) tiles, within AEE 5e-6 of ``run_config``,
launching exactly the configuration's kernels; every rank then runs it
again with each kernel call also run through its plain version on copies
of its inputs, bit for bit (``kernels_against_plain``), so the kernels are
held at the very tiles, stripes, masks, aprons and step counts route 2 gives
them.  The ``biLinear=False`` warp on tiles (``liu_shen_warp_sharded``, three
flows) equals the whole-image warp cropped on every rank, and the two
``biLinear=False`` pyramids run within AEE 5e-6 of the single-device driver
on (1, 2, 2) and (1, 4, 1), their kernel calls held against the plain
versions too, at 512^2 and 2048^2.  ``batch_sharded_scan`` ((4, 1, 1), 16
pairs at 512^2) equals ``scan_pipeline`` bit for bit, and the campaign
runner with the mesh gives the single-device runner's ``done``, ``failed``
and ``.mat`` files, bit for bit.  The ranks share one card: no time of
theirs is a scaling figure, and none is taken.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SHAPE = (2048, 2048)
AEE_BAR = 5e-6   # whole pipeline, against the single-device port
GROUP_TIMEOUT_S = 420   # the group, start-up included
# the kernels of route 2's path
ROUTE2_KERNELS = ("hs_jacobi", "warp_pair", "liu_shen", "lk_build", "lk_gn", "fb_poly_expand",
                  "fb_update_matrices", "fb_blur5_flow")


def warp_flows(shape, dev) -> dict:
    """Three flows for the Liu-Shen warp on tiles, from a seed: sub-pixel;
    integers of |d| <= 5 (collisions, and the top and left borders' negative
    flows wrapping to the far side); and about (0.55 W, -0.7 H), which
    crosses whole tiles."""
    g = np.random.default_rng(11)
    h, w = shape
    flows = {"subpixel": (g.normal(0, 0.6, shape), g.normal(0, 0.6, shape)),
             "integer": (g.integers(-5, 6, shape), g.integers(-5, 6, shape)),
             "crossing": (0.55 * w + 3 * g.normal(size=shape),
                          -0.7 * h + 3 * g.normal(size=shape))}
    return {k: [torch.as_tensor(np.asarray(z, np.float32), device=dev) for z in f]
            for k, f in flows.items()}


@contextlib.contextmanager
def kernels_against_plain(swaps: dict, record: dict):
    """While active, every call of a kernel wrapper named in ``swaps``
    ({name: (module, attribute)}, the attribute the path calls) launches
    the kernel as the path does and also runs the wrapper's plain version
    on copies of the same inputs, made before the kernel ran, and holds the
    two bit for bit (NaN equal to NaN; Liu-Shen's u, v and k: its err is
    not read without the stop).  So the kernels are checked at exactly the
    shapes, masks, aprons and step counts of the calls a run makes.
    ``record[name]`` gathers the calls and the largest difference; a
    disagreement raises when the context ends."""
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(y) for y in x)
        return x

    def outputs(x):
        return list(x) if isinstance(x, (tuple, list)) else [x]

    bad = []

    def checking(name, wrapper, plain):
        def run(*args, **kw):
            copies, kw_copies = clone(args), {k: clone(v) for k, v in kw.items()}
            got = wrapper(*args, **kw)
            want = plain(*copies, **kw_copies)
            rec = record.setdefault(name, {"calls": 0, "max_abs_diff": 0.0})
            rec["calls"] += 1
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
                    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
                    bad.append((name, shapes[:1], kw, d))
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
        raise AssertionError(f"kernel calls disagree with their plain versions: {bad[:8]}")


def rank_main(rank: int, world: int, init: str, work: str) -> None:
    """One rank of the group: runs the sharded entry points on its tiles,
    gathers them to rank 0, which holds them against the single-device port
    on the same card and prints one JSON line a check; any disagreement
    raises (non-zero exit)."""
    from opticalflow_ri_tpu_torch.compile import scan_pipeline
    from opticalflow_ri_tpu_torch.configs import CONFIGS, run_config
    from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
    from opticalflow_ri_tpu_torch.models.farneback import farneback_solve
    from opticalflow_ri_tpu_torch.models.horn_schunck import hs_solve
    from opticalflow_ri_tpu_torch.models.liu_shen import liu_shen_precompute
    from opticalflow_ri_tpu_torch.models.lucas_kanade import lk_dense_solve
    from opticalflow_ri_tpu_torch.ops.cuda import liu_shen_iter
    from opticalflow_ri_tpu_torch.ops.gaussian import gaussian_filter_px
    from opticalflow_ri_tpu_torch.ops.warp import liu_shen_warp
    from opticalflow_ri_tpu_torch.parallel import (
        batch_sharded_scan, batch_sharding, batched_hs_pipeline, distributed,
        farneback_solve_sharded, hs_solve_sharded, liu_shen_solve_sharded,
        lk_solve_sharded_kernel, make_mesh,
    )
    from opticalflow_ri_tpu_torch.parallel.auto import (
        HS_SINGLE_LEVEL, auto_sharded_pipeline, sharded_pipeline_fn,
    )
    from opticalflow_ri_tpu_torch.parallel.sharded_glue import liu_shen_warp_sharded
    from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair
    from test_torch_cuda_graph import WRAPPERS, expected_kernels, launches
    from test_torch_cuda_parallel import (
        LS_WARP_KERNELS, LS_WARP_PYRAMIDS, ROUTE2_AT_2048, ls_warp_pyramid,
    )

    distributed.initialize(init, world, rank, backend="gloo")
    assert "jax" not in sys.modules, "the port imported jax"
    dev = torch.device("cuda", torch.cuda.current_device())
    lead = rank == 0

    def report(rec):
        if lead:
            print(json.dumps(rec), flush=True)

    def check(name, ok, rec):
        report({"check": name, "ok": bool(ok), **rec})
        if lead and not ok:
            raise AssertionError(f"{name} disagrees with the single-device port: {rec}")

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def rel(e, e_ref):
        e, e_ref = float(e), float(e_ref)
        return abs(e - e_ref) / abs(e_ref) if e_ref else abs(e)

    def aee(got, want):
        du, dv = ((g.double() - w.double()) for g, w in zip(got, want))
        return float(torch.hypot(du, dv).mean())

    def counted(call):
        """call()'s result and the kernels it launched."""
        before = launches()
        out = call()
        return out, {k for k, n in launches().items() if n > before[k]}

    def gathered(mesh, tensors, spec):
        return [distributed.gather_global(mesh, t, spec) for t in tensors]

    def per_rank(value):
        values = [None] * world
        torch.distributed.all_gather_object(values, value)
        return values

    pair, pair1 = ([torch.as_tensor(im, device=dev) for im in particle_image_pair(SHAPE, seed=s)[:2]]
                   for s in (0, 1))
    pair512 = [torch.as_tensor(im, device=dev)
               for im in particle_image_pair((512, 512), seed=0)[:2]]
    zero = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
    tiles, rows = ("y", "x"), ("y", None)
    m_tiles, m_rows = make_mesh(shape=(1, 2, 2)), make_mesh(shape=(1, 4, 1))

    # Horn-Schunck on the kernel, (y, x) tiles
    sl = distributed.local_slices(m_tiles, SHAPE, tiles)
    (u, v, err), used = counted(lambda: hs_solve_sharded(m_tiles, pair[0][sl], pair[1][sl], 21.0,
                                                         100, zero[sl], zero[sl]))
    u, v = gathered(m_tiles, (u, v), tiles)
    if lead:
        ref = hs_solve(*pair, 21.0, 100, zero, zero)
        check("hs_solve_sharded, alpha 21, 100 iterations", same((u, v), ref[:2])
              and rel(err, ref[2]) <= 1e-6 and "hs_jacobi" in used,
              {"bitwise": same((u, v), ref[:2]), "err_rel": rel(err, ref[2])})

    # Liu-Shen on the kernel, (y, None) stripes: tol 0 runs all 60 steps
    sl = distributed.local_slices(m_rows, SHAPE, rows)
    (u, v, err), used = counted(lambda: liu_shen_solve_sharded(
        m_rows, pair[0][sl], pair[1][sl], 10.0, zero[sl], zero[sl], max_iter=60, tol=0.0))
    u, v = gathered(m_rows, (u, v), rows)
    if lead:
        a, b = pair
        fields = liu_shen_precompute(a / a.max(), b / b.max(), 10.0)
        ref = liu_shen_iter.liu_shen_iterate(10.0, fields, zero, zero, 60, 0.0)
        check("liu_shen_solve_sharded, h 10, 60 steps, tol 0", same((u, v), ref[:2])
              and int(ref[3]) == 60 and rel(err, ref[2]) <= 1e-6 and "liu_shen" in used,
              {"bitwise": same((u, v), ref[:2]), "err_rel": rel(err, ref[2])})
        del fields, ref

    # the batched pipeline: two pairs over 'batch', tiles over (y, x)
    m_b = make_mesh(shape=(2, 1, 2))
    stack = [torch.stack([pair[i], pair1[i]]) for i in (0, 1)]
    sl = distributed.local_slices(m_b, (2, *SHAPE), distributed.SPEC_BATCH)
    (u, v, err), used = counted(lambda: batched_hs_pipeline(m_b, stack[0][sl], stack[1][sl],
                                                            alpha=21.0, niter=100))
    u, v = gathered(m_b, (u, v), distributed.SPEC_BATCH)
    errs = per_rank((sl[0].start, err.cpu().tolist()))
    if lead:
        err_of = {start + i: e for start, es in errs for i, e in enumerate(es)}
        for k, p in enumerate((pair, pair1)):
            ref = hs_solve(*(gaussian_filter_px(im, 3.4, 3) for im in p), 21.0, 100, zero, zero)
            check(f"batched_hs_pipeline pair {k}, sigma 3.4, alpha 21, 100 iterations",
                  same((u[k], v[k]), ref[:2]) and rel(err_of[k], ref[2]) <= 1e-6
                  and "hs_jacobi" in used, {"bitwise": same((u[k], v[k]), ref[:2])})
    del stack, u, v

    # route 1, run eagerly (sharded_pipeline_fn), against run_config
    sl = distributed.local_slices(m_tiles, SHAPE, tiles)
    hs_tiles = [im[sl].contiguous() for im in pair]
    (u, v), used = counted(lambda: sharded_pipeline_fn("HS_Fs3_4", m_tiles)(*hs_tiles))
    u, v = gathered(m_tiles, (u, v), tiles)
    if lead:
        ref = run_config("HS_Fs3_4", *pair)
        check("sharded_pipeline_fn('HS_Fs3_4'), route 1, against run_config",
              (same((u, v), ref) or aee((u, v), ref) <= AEE_BAR) and "hs_jacobi" in used,
              {"bitwise": same((u, v), ref), "aee": aee((u, v), ref)})

    # the rows-sharded dense LK and Farneback on (y, None) stripes
    sl = distributed.local_slices(m_rows, SHAPE, rows)
    row_tiles = [t[sl].contiguous() for t in (pair[0], pair[1], zero, zero)]
    for label, call, single, kernels in (
            ("lk_solve_sharded_kernel, half window 13, 5 steps, R 5, against lk_dense_solve",
             lambda: lk_solve_sharded_kernel(m_rows, *row_tiles),
             lambda: lk_dense_solve(*pair, zero, zero), {"lk_build", "lk_gn"}),
            ("farneback_solve_sharded, window 33 Gaussian, 5 iterations, against "
             "farneback_solve", lambda: farneback_solve_sharded(m_rows, *row_tiles),
             lambda: farneback_solve(*pair, zero, zero),
             {"fb_update_matrices", "fb_blur5_flow"})):
        got, used = counted(call)
        got = gathered(m_rows, got, rows)
        if lead:
            ref = single()
            check(label, same(got, ref) and kernels <= used,
                  {"bitwise": same(got, ref), "kernels": sorted(used)})
            del ref
        del got
        torch.cuda.empty_cache()

    # the graph-replaying entry refuses CUDA tiles on gloo, naming the eager one
    try:
        auto_sharded_pipeline("HS_Fs3_4", m_tiles)(*hs_tiles)
        raised = None
    except ValueError as e:
        raised = str(e)
    check("auto_sharded_pipeline on CUDA tiles over gloo raises, naming sharded_pipeline_fn",
          raised is not None and "sharded_pipeline_fn" in raised, {"raised": raised})

    # route 2, the sharded pyramid, on (y, x) tiles: each configuration
    # counted, then run again with every kernel call held against its plain
    # version on every rank
    route2_swaps = {k: WRAPPERS[k] for k in ROUTE2_KERNELS}
    route2 = [n for n in CONFIGS if n not in HS_SINGLE_LEVEL]
    launched, plain_calls = set(), {}
    for names, p2 in ((route2, pair512), (ROUTE2_AT_2048, pair)):
        size = p2[0].shape[0]
        sl = distributed.local_slices(m_tiles, p2[0].shape, tiles)
        t2 = [im[sl].contiguous() for im in p2]
        for name in names:
            fn = sharded_pipeline_fn(name, m_tiles)
            (u, v), used = counted(lambda: fn(*t2))
            u, v = gathered(m_tiles, (u, v), tiles)
            record = {}
            with kernels_against_plain(route2_swaps, record):
                fn(*t2)
            torch.cuda.empty_cache()
            records = per_rank(record)
            if lead:
                ref = run_config(name, *p2)
                check(f"sharded_pipeline_fn({name!r}), route 2, at {size}^2 against run_config",
                      aee((u, v), ref) <= AEE_BAR and used == expected_kernels(name),
                      {"bitwise": same((u, v), ref), "aee": aee((u, v), ref),
                       "kernels": sorted(used)})
                launched |= used
                for r in records:
                    for k, rec in r.items():
                        plain_calls[k] = plain_calls.get(k, 0) + rec["calls"]
                del ref
            del u, v
        del t2
        torch.cuda.empty_cache()
    if lead:
        check("route 2 launched every kernel of its path and held each against its plain version",
              launched == set(ROUTE2_KERNELS) and set(plain_calls) == set(ROUTE2_KERNELS),
              {"launched": sorted(launched), "plain_calls": plain_calls})

    # the biLinear=False (Liu-Shen) warp on tiles, then the two pyramids
    ls_swaps = {k: WRAPPERS[k] for k in ("hs_jacobi", "liu_shen")}
    for p2 in (pair512, pair):
        size = p2[0].shape[0]
        flows = warp_flows(p2[0].shape, dev)
        for m in (m_tiles, m_rows):
            sl = distributed.local_slices(m, p2[0].shape, tiles)
            for flow, (fu, fv) in flows.items():
                whole = liu_shen_warp(p2[0], fu, fv)
                got = liu_shen_warp_sharded(p2[0][sl].contiguous(), fu[sl].contiguous(),
                                            fv[sl].contiguous(), m)
                oks = per_rank(bool(torch.equal(got, whole[sl])))
                check(f"liu_shen_warp_sharded, {flow} flow, {size}^2 on {list(m.shape)}, against "
                      f"the whole-image warp cropped", all(oks), {"bitwise_per_rank": oks})
                del whole, got
        del flows
        for m in (m_tiles, m_rows):
            sl = distributed.local_slices(m, p2[0].shape, tiles)
            t2 = [im[sl].contiguous() for im in p2]
            for name in LS_WARP_PYRAMIDS:
                run = ls_warp_pyramid(name, m)
                (u, v), used = counted(lambda: run(*t2))
                u, v = gathered(m, (u, v), tiles)
                record = {}
                with kernels_against_plain(ls_swaps, record):
                    run(*t2)
                records = per_rank(record)
                if lead:
                    ref = ls_warp_pyramid(name, None)(*p2)
                    kernel = LS_WARP_KERNELS[name]
                    calls = sum(r.get(kernel, {}).get("calls", 0) for r in records)
                    check(f"biLinear=False pyramid ({name}) on {list(m.shape)} at {size}^2 "
                          f"against the single-device driver",
                          aee((u, v), ref) <= AEE_BAR and used == {kernel} and calls > 0,
                          {"aee": aee((u, v), ref), "kernels": sorted(used),
                           "plain_calls": calls})
                    del ref
                del u, v
            del t2
            torch.cuda.empty_cache()

    # the batch-sharded scan: 16 pairs at 512^2 over four ranks
    m_s = make_mesh(shape=(4, 1, 1))
    stacks = [particle_image_pair(shape=(512, 512), seed=s)[:2] for s in range(16)]
    s1, s2 = (torch.as_tensor(np.stack([p[i] for p in stacks]), device=dev) for i in (0, 1))
    take = batch_sharding(m_s)
    us, vs = batch_sharded_scan("HS_Fs3_4", m_s)(take(s1), take(s2))
    us, vs = gathered(m_s, (us, vs), ("batch", None, None))
    if lead:
        ref = scan_pipeline("HS_Fs3_4")(s1, s2)
        check("batch_sharded_scan('HS_Fs3_4'), 16 pairs at 512^2", same((us, vs), ref),
              {"bitwise": same((us, vs), ref)})

    # the runner with the mesh on the campaign's pairs: a run, then a resume
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


def run_group(work: str) -> list:
    """Spawn ``WORLD`` ranks of ``rank_main`` on the one card and wait for
    all; returns rank 0's output lines.  A rank that fails, or a group that
    outlasts ``GROUP_TIMEOUT_S``, stops every rank and fails the test."""
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    init = f"file://{os.path.join(work, 'rendezvous')}"
    # each rank's output to files, read once the group has ended: a pipe that
    # nobody reads would stop a rank that writes more than it holds
    logs = [[os.path.join(work, f"rank{r}.{k}") for k in ("out", "err")] for r in range(WORLD)]
    procs = []
    try:
        for r in range(WORLD):
            with open(logs[r][0], "w") as out, open(logs[r][1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), init, work],
                    stdout=out, stderr=err, env=env, cwd=ROOT))
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = [[open(path).read() for path in paths] for paths in logs]
    codes = [p.returncode for p in procs]
    tails = "\n".join(f"rank {r} exit {codes[r]}:\n" + "\n".join(err.splitlines()[-25:])
                      for r, (_, err) in enumerate(texts) if codes[r])
    assert not any(codes), f"the group of {WORLD} gloo ranks failed\n{texts[0][0]}\n{tails}"
    return texts[0][0].splitlines()


def test_four_gloo_ranks_equal_single_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    from opticalflow_ri_tpu_torch.harness.batch_runner import FlowBatchRunner
    from opticalflow_ri_tpu_torch.ops.cuda import build
    from test_torch_cuda_campaign import CONFIG, read_flow, write_campaign

    work = str(tmp_path)
    pairs = write_campaign(work)
    with open(os.path.join(work, "pairs.json"), "w") as f:
        json.dump(pairs, f)
    build.build()  # once, before the ranks load it
    torch.cuda.empty_cache()
    records = [json.loads(line) for line in run_group(work) if line.startswith("{")]
    assert [r for r in records if "check" in r] and all(r["ok"] for r in records if "check" in r)
    (mesh_run,) = [r for r in records if "runner" in r]
    out = os.path.join(work, "out")
    first = FlowBatchRunner(CONFIG, batch_size=8, output_dir=out).run(pairs[:16])
    state = FlowBatchRunner(CONFIG, batch_size=8, output_dir=out).run(pairs)
    assert mesh_run["first_done"] == sorted(first["done"])
    assert mesh_run["done"] == sorted(state["done"])
    assert mesh_run["failed"] == sorted(state["failed"])
    for name in mesh_run["done"]:
        got = read_flow(os.path.join(work, "out_mesh", f"{name}.mat"))
        for g, w in zip(got, read_flow(os.path.join(out, f"{name}.mat"))):
            np.testing.assert_array_equal(g, w)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
