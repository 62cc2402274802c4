"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so the build takes seconds.  The library lands in
``build/opticalflow_ri_tpu_torch/`` beside the package, under a name keyed by
a hash of the sources and flags, and is built at the first CUDA launch —
never at import.

``-fmad=false`` keeps nvcc from contracting a product and a sum into one
fused multiply-add, so every kernel rounds exactly as its plain PyTorch
version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "opticalflow_ri_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin (default /usr/local/cuda): "
            "the CUDA kernels of opticalflow_ri_tpu_torch are built from csrc/ at first use")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libofri_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; returns
    its path.  nvcc's ``-Xptxas -v`` report (registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent processes never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.ofri_error_string.argtypes = [ctypes.c_int]
    lib.ofri_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = load_library().ofri_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_fields(what: str, *fields: torch.Tensor) -> None:
    """Validate a kernel's tensor arguments: one CUDA device, float32, one
    (H, W) shape with H, W >= 2, contiguous."""
    shape = fields[0].shape
    for f in fields:
        if f.device.type != "cuda" or f.device != fields[0].device:
            raise ValueError(f"{what}: all fields must be on one CUDA device, got {f.device}")
        if f.dtype != torch.float32:
            raise TypeError(f"{what}: fields must be float32, got {f.dtype}")
        if f.shape != shape or f.dim() != 2:
            raise ValueError(f"{what}: fields must share one (H, W) shape, got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError(f"{what}: fields must be contiguous")
    if shape[0] < 2 or shape[1] < 2:
        raise ValueError(f"{what}: fields must be at least 2x2, got {tuple(shape)}")
