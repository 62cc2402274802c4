"""Timing and profiling helpers (port of ``utils/timing.py``).

  * ``force`` waits until the work queued for some tensors has run;
  * ``span`` names a stage of the program in a ``torch.profiler`` trace:
    a range ``ofri.<name>`` while a profiler session is on in the process,
    else a shared null context;
  * ``trace`` records a ``torch.profiler`` trace (CPU and, where there is a
    card, CUDA activity, on every thread) into a directory, viewable in
    TensorBoard or Perfetto.

Spans nest as the stages do (``ofri.level2`` around ``ofri.solve`` around
``ofri.expand``).  A range opened while a CUDA graph is captured is not
seen at replay: the profiler links every kernel of the graph to its one
``cudaGraphLaunch``, inside the caller's ``ofri.replay``.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def force(*tensors) -> None:
    """Wait for the current stream of each CUDA tensor's device, on which
    the work that writes it was queued.  CPU tensors are done already;
    arguments that are not tensors are ignored."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def span(name: str):
    """A range ``ofri.<name>`` while a profiler session is on, else one
    shared ``nullcontext``.  The check is torch's process-wide flag (a module
    attribute, ~0.05 us on a host CPU core), not the profiler's thread-local
    state, so a runner's worker threads name their stages in ``trace`` too;
    an unguarded ``record_function`` costs ~7 us there even with no
    profiler.

    The range is an operator-scope record (``_RecordFunctionFast``), not a
    ``record_function`` user annotation: the profiler draws a user
    annotation a second time on the device timeline, over the device work
    launched inside it, and a reader of device activity would count that
    shadow as work.  An operator-scope range has no such shadow."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast("ofri." + name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block, on every thread of
    the process, into ``log_dir``; yields the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
