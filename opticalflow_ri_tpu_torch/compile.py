"""Whole-config pipelines: one CUDA graph per (config, image shape), and
the same for a rank's tiles of a sharded run.

The JAX package traces a calibrated configuration into one XLA program per
input shape, so a pair is one dispatch (``compile.py:29-45`` there).  Here
``compiled_pipeline(name)`` captures one run of the configuration in a CUDA
graph per (H, W, device) and replays it: a pair is the copy of its two
images into the graph's input buffers and one graph launch, and the host
enqueues a few calls in place of the hundreds of launches of the eager
path.  Adapters are built fresh for the capture, so a stateful calibration
list (the HS alphas) resolves at capture time, as it does at trace time in
JAX.

    fn = compiled_pipeline("PyHSchunck_Fs3_4")
    U, V = fn(im1, im2)                       # CUDA: a graph replay
    us, vs = scan_pipeline("HS_Fs3_4")(im1s, im2s)   # (K, H, W) stacks

The first call at a shape runs the pipeline once eagerly on a side stream
(``warm_up``: it builds the kernel library, opts the kernels into shared
memory and puts the host-built constants on the device, none of which a
capture allows), then captures.  A failure to capture or replay raises;
there is no eager fallback on the card.  CPU inputs (``device="cpu"``, or
CPU tensors) run the eager path.  A kernel wrapper's ``launches`` counter
counts at capture, not at replay.

Under a ``torch.profiler`` session a call names its stages
(``utils/timing.span``): ``ofri.pin`` (a frame's host copy into pinned
memory), ``ofri.h2d`` (its copies into the graph's input), ``ofri.replay``,
``ofri.clone`` (a pair's outputs), ``ofri.gather`` (a scan's slot copies)
and ``ofri.capture`` (warm-up and capture at a new shape).

``CompiledPipeline`` takes any run function with the signature of
``build_config(name).run``: ``parallel.auto.auto_sharded_pipeline`` gives
it a rank's sharded pipeline (``parallel.auto.sharded_pipeline_fn``) on
one mesh, and holds one graph per (tile H, tile W, device).  The warm-up
run of a sharded pipeline also creates the process group's communicators,
which a capture must not do; every rank then captures the same sequence
of collectives.

``batched_pipeline`` (a ``vmap`` over pairs) is not ported: the JAX package
deprecates it (slower than the scan at a larger working set), and
``scan_pipeline`` is its replacement there too.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from opticalflow_ri_tpu_torch.configs import build_config
from opticalflow_ri_tpu_torch.utils.device import resolve
from opticalflow_ri_tpu_torch.utils.timing import span


def pipeline_fn(name: str):
    """An (im1, im2, device="cuda") -> (U, V) function for a named calibrated
    config.  Each call builds fresh adapters, so alpha lists start full."""
    cfg = build_config(name)

    def fn(im1, im2, device="cuda"):
        return cfg.run(im1, im2, device=device)

    return fn


def _device_of(im, device) -> torch.device:
    """Where a pair runs: a tensor's own device, else ``device``."""
    return resolve(im.device if isinstance(im, torch.Tensor) else device)


def _check_pair(im1, im2, ndim: int) -> tuple:
    shape = tuple(im1.shape)
    if len(shape) != ndim or tuple(im2.shape) != shape:
        raise ValueError(f"expected two arrays of one {ndim}-d shape, got {shape} and "
                         f"{tuple(im2.shape)}")
    return shape


def _to_device(x, device: torch.device, into=None) -> torch.Tensor:
    """``x`` as float32 on ``device``, copied on into the buffer ``into`` if
    given: a tensor is cast in place on its own device, a numpy array goes
    through pinned memory (``ofri.pin``) without waiting.  The copies are one
    span ``ofri.h2d``."""
    if not isinstance(x, torch.Tensor):
        with span("pin"):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).pin_memory()
    with span("h2d"):
        x = x.to(device=device, dtype=torch.float32, non_blocking=x.is_pinned())
        if into is not None:
            into.copy_(x)
    return x


class _Graph(NamedTuple):
    """One captured pair: its input buffers, the graph and its outputs."""
    inputs: tuple
    graph: torch.cuda.CUDAGraph
    outputs: tuple


class CompiledPipeline:
    """``compiled_pipeline(name)``: ``fn(im1, im2, device="cuda") -> (U, V)``,
    fresh float32 tensors on the pair's device.  ``run`` (default: the
    config's ``build_config(name).run``) is what is warmed up, captured and
    replayed, ``run(im1, im2, device=...) -> (U, V)``, one graph per
    (h, w, device).  Not thread-safe: call it from one thread at a time."""

    def __init__(self, name: str, run=None):
        self.name = name
        self._run = build_config(name).run if run is None else run
        self._graphs: dict = {}   # (h, w, device) -> _Graph
        self._warm: set = set()   # (h, w, device) run once eagerly

    def __call__(self, im1, im2, device="cuda"):
        dev = _device_of(im1, device)
        if dev.type != "cuda":
            return self._run(im1, im2, device=dev)
        u, v = self.replay(im1, im2, dev)
        with span("clone"):
            return u.clone(), v.clone()

    def replay(self, im1, im2, device="cuda"):
        """Copy the pair into the graph of its shape (captured at the first
        call) and replay it on the current stream; returns the graph's own
        output buffers, which the next replay overwrites."""
        dev = _device_of(im1, device)
        if dev.type != "cuda":
            raise ValueError(f"replay runs a CUDA graph, not on {dev}")
        key = (*_check_pair(im1, im2, 2), dev)
        g = self._graphs.get(key)
        if g is None:
            with span("capture"):
                g = self._graphs[key] = self._capture(key, im1, im2)
        for buf, im in zip(g.inputs, (im1, im2)):
            _to_device(im, dev, into=buf)
        with span("replay"):
            g.graph.replay()
        return g.outputs

    def warm_up(self, im1, im2, device="cuda") -> None:
        """Run the pipeline once eagerly on a side stream at the pair's
        shape, unless that shape is warm already.  The first call at a shape
        does this itself before it captures."""
        dev = _device_of(im1, device)
        key = (*_check_pair(im1, im2, 2), dev)
        if key in self._warm or dev.type != "cuda":
            return
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run(_to_device(im1, dev), _to_device(im2, dev), device=dev)
            torch.cuda.current_stream(dev).wait_stream(side)
        self._warm.add(key)

    def _capture(self, key, im1, im2) -> _Graph:
        h, w, dev = key
        self.warm_up(im1, im2, dev)
        inputs = tuple(torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(2))
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (a runner's decoder and copies) keep
        # allocating and copying while this one captures
        with torch.cuda.device(dev), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self._run(*inputs, device=dev)
        return _Graph(inputs, graph, outputs)

    def release(self) -> None:
        """Free every captured graph with its memory pool and buffers; the
        next call at a shape captures again."""
        graphs, self._graphs = self._graphs, {}
        for g in graphs.values():
            g.graph.reset()
        graphs.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@lru_cache(maxsize=None)
def compiled_pipeline(name: str) -> CompiledPipeline:
    """The graph-replaying pipeline of ``name``, one per name (see the
    module docstring)."""
    return CompiledPipeline(name)


@lru_cache(maxsize=None)
def scan_pipeline(name: str):
    """``fn(im1s, im2s, device="cuda") -> (us, vs)`` over (K, H, W) stacks:
    the pairs run one after another on the device with the single-pair
    working set.  On CUDA each pair is a replay of ``compiled_pipeline
    (name)``'s graph for (H, W), its flow copied into slot k of the outputs,
    with no host wait between pairs; on the CPU a loop over the eager path.
    ``fn.release()`` frees the graphs."""
    pipe = compiled_pipeline(name)

    def scanned(im1s, im2s, device="cuda"):
        k, h, w = _check_pair(im1s, im2s, 3)
        dev = _device_of(im1s, device)
        us, vs = (torch.empty((k, h, w), dtype=torch.float32, device=dev) for _ in range(2))
        if dev.type == "cuda":
            im1s, im2s = _to_device(im1s, dev), _to_device(im2s, dev)
        for i in range(k):
            u, v = (pipe.replay if dev.type == "cuda" else pipe)(im1s[i], im2s[i], dev)
            with span("gather"):
                us[i].copy_(u)
                vs[i].copy_(v)
        return us, vs

    scanned.release = pipe.release
    return scanned
