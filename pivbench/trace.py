"""The traced window: ``torch.profiler`` over CPU and CUDA activity, kept in
memory, reduced to device intervals and the benchmark's own spans.

The spans are ``record_function`` ranges the benchmark opens around its
calls into the program: ``loop`` around the whole window, ``entry`` around
each call of the entry, ``fetch`` around each copy of the flows to host
memory.  Their times and the device activity's come from the same trace,
on one clock.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import torch

SPANS = ("loop", "entry", "fetch")


@dataclass
class DeviceOp:
    name: str
    kind: str          # kernel, htod, dtoh, dtod, memset
    start: int         # ns
    end: int


@dataclass
class Trace:
    ops: list = field(default_factory=list)      # DeviceOp, sorted by start
    spans: list = field(default_factory=list)    # (name, start, end) ns

    def window(self) -> tuple:
        """(start, end) ns of the ``loop`` span."""
        loops = [(s, e) for n, s, e in self.spans if n == "loop"]
        if len(loops) != 1:
            raise ValueError(f"expected one loop span in the trace, found {len(loops)}")
        return loops[0]


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        for key in ("HtoD", "DtoH"):
            if key in name:
                return key.lower()
        return "dtod"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def span(name: str, on: bool):
    """A ``record_function`` range when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the block; yields a ``Trace`` filled when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = Trace()
    with profile(activities=acts) as prof:
        yield out
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name in SPANS:      # the spans' shadows on the device timeline
                continue
            out.ops.append(DeviceOp(name, kind_of(name), start, end))
        elif name in SPANS:
            out.spans.append((name, start, end))
    out.ops.sort(key=lambda o: o.start)


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def clip(intervals, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_ns(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def gaps(busy: list, lo: int, hi: int) -> list:
    """The idle (start, end) intervals of [lo, hi] between ``busy`` (disjoint,
    sorted)."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def span_at(spans: list, t: int) -> str:
    """The innermost benchmark span open at time t."""
    best, width = "loop", None
    for name, s, e in spans:
        if name != "loop" and s <= t <= e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def short_name(name: str) -> str:
    """A device op's name without its parameter list and anonymous
    namespace, at most 80 characters."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return base.split("(", 1)[0].strip()[:80] or name[:80]


def matches(name: str, kernel: str) -> bool:
    """Whether the traced op ``name`` is the kernel ``kernel`` (the whole
    identifier, as ``__global__`` declares it)."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])", name) is not None


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the window by the span the host was in."""
    lo, hi = tr.window()
    totals: dict = {}
    for o in tr.ops:
        if o.end > lo and o.start < hi:
            key = short_name(o.name)
            totals[key] = totals.get(key, 0) + min(o.end, hi) - max(o.start, lo)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    busy = union(clip([(o.start, o.end) for o in tr.ops], lo, hi))
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[span_at(tr.spans, (s + e) // 2), (e - s) / 1e9] for s, e in idle]}


def stage_ns(ctx: dict, stage: str) -> int:
    """The device time of the window's kernels of ``stage``."""
    names = ctx["stages"].get(stage, [])
    return sum(o.end - o.start for o in ctx["ops"]
               if o.kind == "kernel" and any(matches(o.name, k) for k in names))
