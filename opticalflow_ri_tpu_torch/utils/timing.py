"""Timing and profiling helpers (port of ``utils/timing.py``).

  * ``force`` waits until the work queued for some tensors has run;
  * ``StageTimer`` adds up wall-clock time per named stage, each stage
    forced to completion;
  * ``trace`` records a ``torch.profiler`` trace (CPU and, where there is a
    card, CUDA activity) into a directory, viewable in TensorBoard or
    Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def force(*tensors) -> None:
    """Wait for the current stream of each CUDA tensor's device, on which
    the work that writes it was queued.  CPU tensors are done already;
    arguments that are not tensors are ignored."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *outputs):
        t0 = time.perf_counter()
        yield
        force(*outputs)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:<30} {t*1e3:9.2f} ms total  {t/n*1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
