"""Environment check (port of ``utils/envcheck.py``, ref: test_env.py).

Prints the versions of the numerics stack, CUDA, ``nvcc``, the visible
devices and the GPU's name and power limit.  Optional packages (PIL,
matplotlib) and a missing card or toolkit report None and do not fail.
Run: ``python3 -m opticalflow_ri_tpu_torch.utils.envcheck``
"""

from __future__ import annotations

import importlib
import subprocess


def _version(module: str):
    try:
        return importlib.import_module(module).__version__
    except ImportError:
        return None


def _first_line(cmd: list, last: bool = False):
    """The first (or last) line a command prints, or None where it cannot run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return (lines[-1] if last else lines[0]) if lines else None


def report() -> dict:
    import torch

    from opticalflow_ri_tpu_torch.ops.cuda import build

    info = {"numpy": _version("numpy"), "scipy": _version("scipy"), "torch": torch.__version__,
            "cuda": torch.version.cuda, "pillow": _version("PIL"),
            "matplotlib": _version("matplotlib")}
    try:
        info["nvcc"] = _first_line([build.find_nvcc(), "--version"], last=True)
    except RuntimeError:
        info["nvcc"] = None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["devices"] = [torch.cuda.get_device_name(i) for i in range(n)] or ["cpu"]
    info["device_count"] = n
    info["gpu_name_power_limit"] = _first_line(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return info


def main():
    for key, val in report().items():
        print(f"{key}: {val}")


if __name__ == "__main__":
    main()
