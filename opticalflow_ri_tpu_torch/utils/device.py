"""Moving host-built constants (pad indices, resize matrices) to a device."""

from __future__ import annotations

import numpy as np
import torch


def host_to(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  A copy to a CUDA device goes
    through pinned memory and does not wait: a pageable copy would make the
    host wait for every kernel queued before it."""
    t = torch.from_numpy(array)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
