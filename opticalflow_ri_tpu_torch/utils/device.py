"""Host-built constants (pad indices, resize matrices, ramps) on a device.

``device_constant`` keeps each constant on its device once it has been
copied there, keyed by (function, arguments, device).  After one run at a
shape the pipeline copies nothing from the host, which is what lets it be
captured in a CUDA graph: a copy from host memory cannot be captured, and
a captured copy would read a host buffer that is handed out again after
the capture.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_CONSTANTS: dict = {}
_LOCK = threading.Lock()


def host_to(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  The copy has finished when this
    returns, so any stream may read the tensor; it waits for the work queued
    on the current stream, which ``device_constant`` pays once per constant."""
    return torch.from_numpy(array).to(device)


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_constant(make, *args, device) -> torch.Tensor | tuple:
    """``make(*args)``, a numpy array or a tuple of them, as tensors on
    ``device``: built and copied at the first request for (make, args,
    device), then kept.  ``make`` must be a pure function of ``args``.
    Raises when the copy would have to run inside a graph capture."""
    device = resolve(device)
    key = (make, args, device)
    found = _CONSTANTS.get(key)
    if found is not None:
        return found
    if device.type == "cuda" and capturing():
        raise RuntimeError(
            f"{make.__name__}{args} is not on {device} yet and cannot be copied during a CUDA "
            f"graph capture: run the same work once before capturing it")
    host = make(*args)
    value = (tuple(host_to(a, device) for a in host) if isinstance(host, tuple)
             else host_to(host, device))
    with _LOCK:
        return _CONSTANTS.setdefault(key, value)
