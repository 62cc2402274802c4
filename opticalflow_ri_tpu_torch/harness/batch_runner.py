"""Campaign runner: datasets of image pairs through ``compile.scan_pipeline``
with prefetching, checkpoint and resume, failure isolation and profiling
(port of ``harness/batch_runner.py``).

  * a batch of pairs is one ``scan_pipeline`` call: on CUDA one graph replay
    a pair, with no host wait between pairs; a producer thread decodes the
    next batch (the native TIFF runtime) into pinned memory and copies it to
    the card on a copy stream while the card computes;
  * ``progress.json`` records the completed pairs; a run with the same
    output directory resumes where the last one stopped;
  * a failed batch (a missing or corrupt frame) is logged and recorded under
    ``failed``, and the campaign goes on;
  * ``profile_dir`` records a ``torch.profiler`` trace of the steady state
    (from the second batch on), on every thread: the producer's spans
    ``ofri.decode`` and ``ofri.upload``, the writer's ``ofri.wait`` (for the
    batch's compute) and ``ofri.write`` (copy to host, ``.mat`` files), beside
    the entry's and the pyramid's (``utils/timing.span``);
  * ``mesh`` (a ("batch", 1, 1) mesh, ``parallel.make_mesh``) shards each
    batch over the ranks of a process group: every rank runs the runner on
    the same pair list, decodes, computes (``scan_pipeline``, which is what
    ``parallel.batch_sharded_scan`` returns) and writes only its slice of
    each batch.  A batch fails on every rank
    when a pair of it fails to load on any (one ``all_gather_object`` per
    batch); the ``done`` and ``failed`` sets are gathered at each
    checkpoint and rank 0 alone writes ``progress.json``, which a resume
    reads on every rank.

    python3 -m opticalflow_ri_tpu_torch.harness.batch_runner --config HS_Fs3_4 \\
        --glob0 'data/*_0.tif' --glob1 'data/*_1.tif' --out flow_out

    torchrun --nproc-per-node 4 -m opticalflow_ri_tpu_torch.harness.batch_runner \\
        --config HS_Fs3_4 --glob0 'data/*_0.tif' --glob1 'data/*_1.tif' \\
        --out flow_out --batch-size 8 --mesh-batch 4
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from queue import Queue

import numpy as np
import torch

from opticalflow_ri_tpu_torch.utils.device import resolve

log = logging.getLogger("opticalflow_ri_tpu_torch")


class FlowBatchRunner:
    def __init__(self, config_name: str, batch_size: int = 4, output_dir: str = "flow_out",
                 save_outputs: bool = True, checkpoint_every: int = 1,
                 profile_dir: str | None = None, pipeline: str = "scan", device="cuda",
                 mesh=None):
        if pipeline == "batched":
            raise ValueError("pipeline='batched' (the vmapped batched_pipeline) is deprecated in "
                             "the JAX package and not ported; use pipeline='scan'")
        if pipeline != "scan":
            raise ValueError(f"pipeline must be 'scan', got {pipeline!r}")
        self.config_name = config_name
        self.pipeline = pipeline
        self.batch_size = int(batch_size)
        # ``mesh``: each batch sharded over the mesh 'batch' axis, every rank
        # streaming its own slice through the scan pipeline, no collective in
        # the compute (parallel/batch_stream.py)
        self.mesh = mesh
        if mesh is not None:
            from opticalflow_ri_tpu_torch.parallel.mesh import axis_index, axis_size

            nb = axis_size(mesh, "batch")
            if self.batch_size % nb:
                raise ValueError(f"batch_size {self.batch_size} must be a multiple of the mesh "
                                 f"batch axis ({nb})")
            if axis_size(mesh, "y") * axis_size(mesh, "x") != 1:
                raise ValueError("a campaign mesh shards pairs only: its y and x axes must be 1")
            self._slice = slice(axis_index(mesh, "batch") * (self.batch_size // nb),
                                (axis_index(mesh, "batch") + 1) * (self.batch_size // nb))
            # the object collectives: one group for the producer thread, one
            # for the writer thread and the end of the run, each used by one
            # thread at a time, in the same order on every rank
            import torch.distributed as dist

            self._load_group = dist.new_group(backend="gloo")
            self._state_group = dist.new_group(backend="gloo")
        self.output_dir = output_dir
        self.save_outputs = save_outputs
        self.checkpoint_every = checkpoint_every
        self.profile_dir = profile_dir
        self.device = resolve(device)
        os.makedirs(output_dir, exist_ok=True)
        self._ckpt_path = os.path.join(output_dir, "progress.json")

    # -- checkpointing ------------------------------------------------------

    def _load_checkpoint(self) -> dict:
        if os.path.exists(self._ckpt_path):
            with open(self._ckpt_path) as f:
                return json.load(f)
        return {"config": self.config_name, "done": [], "failed": []}

    def _save_checkpoint(self, state: dict) -> None:
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._ckpt_path)

    # -- pipeline -----------------------------------------------------------

    def run(self, pairs) -> dict:
        """``pairs``: list of (name, im1_path, im2_path).  Returns the final
        checkpoint state, with timing stats added.

        Three stages overlap, so the card does not wait on host IO:

          producer thread : decode a batch into pinned memory, copy it to the
                            card on the copy stream, record an event
          main loop       : the compute stream waits on that event, then
                            ``scan_pipeline`` (no host wait)
          writer thread   : wait on the event recorded after the batch,
                            copy the flows to pinned memory, write the
                            ``.mat`` files; the sole owner of the state
        """
        from opticalflow_ri_tpu_torch.compile import scan_pipeline
        from opticalflow_ri_tpu_torch.utils.io import load_image_batch, save_flow
        from opticalflow_ri_tpu_torch.utils.timing import span, trace

        state = self._load_checkpoint()
        if state.get("config") != self.config_name:
            raise ValueError(
                f"checkpoint in {self.output_dir} belongs to config "
                f"{state.get('config')!r}, not {self.config_name!r}")
        done = set(state["done"])
        todo = [p for p in pairs if p[0] not in done]
        if not todo:
            return state

        meshed = self.mesh is not None
        if meshed:
            import torch.distributed as dist

            mine = {"done": [], "failed": []}  # this rank's names since the last gather
        fn = scan_pipeline(self.config_name)
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            compute = torch.cuda.current_stream(dev)
            copy_stream, d2h_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

        batches = [todo[i : i + self.batch_size] for i in range(0, len(todo), self.batch_size)]
        in_q: Queue = Queue(maxsize=2)
        out_q: Queue = Queue(maxsize=2)  # bounds the batches in flight on the card

        def upload(arr: np.ndarray) -> torch.Tensor:
            host = torch.from_numpy(arr)
            return host.pin_memory().to(dev, non_blocking=True) if cuda else host

        def agree(error):
            """Every rank's load outcome for this batch: the batch fails on
            every rank if it failed on any."""
            every = [None] * dist.get_world_size(self._load_group)
            dist.all_gather_object(every, None if error is None else repr(error),
                                   group=self._load_group)
            bad = [(r, e) for r, e in enumerate(every) if e is not None]
            return error or (RuntimeError(f"a pair of this batch failed to load on rank "
                                          f"{bad[0][0]}: {bad[0][1]}") if bad else None)

        def producer():
            for chunk in batches:
                if meshed:
                    chunk = chunk[self._slice]
                names = [c[0] for c in chunk]
                try:
                    error = None
                    if chunk:  # this rank's slice of a ragged tail may be empty
                        try:
                            with span("decode"):
                                im1 = load_image_batch([c[1] for c in chunk])
                                im2 = load_image_batch([c[2] for c in chunk])
                        except Exception as e:
                            error = e
                    if meshed:
                        error = agree(error)
                    if error is not None:
                        raise error
                    if not chunk:
                        in_q.put((names, None, None, None))
                        continue
                    n_real = im1.shape[0]
                    if n_real < self.batch_size and not meshed:  # pad the ragged tail
                        pad = self.batch_size - n_real
                        im1 = np.concatenate([im1, np.repeat(im1[-1:], pad, 0)])
                        im2 = np.concatenate([im2, np.repeat(im2[-1:], pad, 0)])
                    ready = None
                    with (torch.cuda.stream(copy_stream) if cuda else contextlib.nullcontext(),
                          span("upload")):
                        g1, g2 = upload(im1), upload(im2)
                        if cuda:
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                    in_q.put((names, g1, g2, ready))
                except Exception as e:  # a batch that cannot be read fails alone
                    in_q.put((names, e, None, None))
            in_q.put(None)

        def to_host(t: torch.Tensor) -> np.ndarray:
            if not cuda:
                return t.numpy()
            with torch.cuda.stream(d2h_stream):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t.record_stream(d2h_stream)
            d2h_stream.synchronize()
            return host.numpy()

        stats = {"batches": 0, "compute_wait_s": 0.0, "transfer_save_s": 0.0}

        def gather_state():
            """Every rank's names since the last gather added to ``state``,
            the same on every rank; rank 0 writes it."""
            every = [None] * dist.get_world_size(self._state_group)
            dist.all_gather_object(every, mine, group=self._state_group)
            for key in ("done", "failed"):
                state[key].extend(n for m in every for n in m[key])
                mine[key] = []
            if dist.get_rank() == 0:
                self._save_checkpoint(state)

        def record(key, names):
            (mine if meshed else state)[key].extend(names)

        def writer():
            # The writer is the sole owner of ``state`` while the pipeline
            # runs: the main loop sends its failures through out_q, so a
            # checkpoint is never written in the middle of an update.  With
            # a mesh every batch is one checkpoint step on every rank, its
            # slice empty, failed or done, so the gathers pair up.
            n_items = 0
            while True:
                item = out_q.get()
                if item is None:
                    return
                names, us, vs, finished = item
                if us is None:  # failure already logged by the main loop
                    record("failed", names)
                else:
                    try:
                        t0 = time.perf_counter()
                        if finished is not None:
                            with span("wait"):
                                finished.synchronize()
                        t1 = time.perf_counter()
                        with span("write"):
                            un, vn = to_host(us), to_host(vs)
                            if self.save_outputs:
                                for i, name in enumerate(names):
                                    save_flow(un[i], vn[i],
                                              os.path.join(self.output_dir, f"{name}.mat"))
                        stats["compute_wait_s"] += t1 - t0
                        stats["transfer_save_s"] += time.perf_counter() - t1
                    except Exception as e:
                        log.error("compute failed for %s: %r", names, e)
                        record("failed", names)
                    else:
                        record("done", names)
                        stats["batches"] += 1
                        if not meshed and stats["batches"] % self.checkpoint_every == 0:
                            self._save_checkpoint(state)
                n_items += 1
                if meshed and n_items % self.checkpoint_every == 0:
                    gather_state()

        threading.Thread(target=producer, daemon=True).start()
        writer_t = threading.Thread(target=writer, daemon=True)
        writer_t.start()

        n_dispatched = 0
        t0_all = time.perf_counter()
        with contextlib.ExitStack() as profiling:
            while True:
                item = in_q.get()
                if item is None:
                    break
                names, im1, im2, ready = item
                if isinstance(im1, Exception):
                    log.error("load failed for %s: %r", names, im1)
                    out_q.put((names, None, None, None))
                    continue
                if im1 is None:  # an empty slice: nothing to compute or record
                    out_q.put((names, None, None, None))
                    continue
                if self.profile_dir and n_dispatched == 1:
                    profiling.enter_context(trace(self.profile_dir))
                try:
                    finished = None
                    if cuda:
                        compute.wait_event(ready)
                        for t in (im1, im2):  # allocated on the copy stream
                            t.record_stream(compute)
                    us, vs = fn(im1, im2, device=dev)
                    if cuda:
                        finished = torch.cuda.Event()
                        finished.record(compute)
                except Exception as e:
                    log.error("dispatch failed for %s: %r", names, e)
                    out_q.put((names, None, None, None))
                    continue
                out_q.put((names, us, vs, finished))
                n_dispatched += 1
            out_q.put(None)
            writer_t.join()
        wall = time.perf_counter() - t0_all
        if meshed:
            gather_state()
            stats["batches"] = len(batches)
        state["batches"] = stats["batches"]
        if stats["batches"]:
            state["seconds_per_batch"] = wall / stats["batches"]
            state["compute_wait_s"] = stats["compute_wait_s"]
            state["transfer_save_s"] = stats["transfer_save_s"]
        if not meshed or dist.get_rank() == 0:
            self._save_checkpoint(state)
        if meshed:  # a resume reads progress.json on every rank
            dist.barrier(group=self._state_group)
        return state


def pairs_from_glob(pattern0: str, pattern1: str):
    """Build (name, path0, path1) pairs from two glob patterns that sort into
    correspondence (e.g. 'data/*_0.tif' and 'data/*_1.tif')."""
    import glob

    first = sorted(glob.glob(pattern0))
    second = sorted(glob.glob(pattern1))
    if len(first) != len(second):
        raise ValueError(f"pair count mismatch: {len(first)} vs {len(second)}")
    pairs = []
    for p0, p1 in zip(first, second):
        name = os.path.splitext(os.path.basename(p0))[0]
        pairs.append((name, p0, p1))
    return pairs


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--glob0", required=True, help="glob for frame-0 images")
    ap.add_argument("--glob1", required=True, help="glob for frame-1 images")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--out", default="flow_out")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--pipeline", choices=("scan", "batched"), default="scan",
                    help="'batched' is deprecated and refused")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--mesh-batch", type=int, default=0,
                    help="shard each batch over N ranks (the mesh batch axis), one process "
                         "each: run under torchrun --nproc-per-node N; batch-size must be a "
                         "multiple of N")
    args = ap.parse_args()

    mesh = None
    if args.mesh_batch > 1:
        from opticalflow_ri_tpu_torch.parallel import distributed, make_mesh

        distributed.initialize(device=args.device)
        mesh = make_mesh(args.mesh_batch, batch=args.mesh_batch, device_type=args.device)

    runner = FlowBatchRunner(args.config, batch_size=args.batch_size, output_dir=args.out,
                             profile_dir=args.profile_dir, pipeline=args.pipeline,
                             device=args.device, mesh=mesh)
    state = runner.run(pairs_from_glob(args.glob0, args.glob1))
    done = len(state.get("done", []))
    failed = len(state.get("failed", []))
    spb = state.get("seconds_per_batch")
    rate = f", {args.batch_size / spb:.1f} pairs/s" if spb else ""
    print(f"{done} pairs done, {failed} failed{rate} -> {args.out}")


if __name__ == "__main__":
    main()
