"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into one shared library
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
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
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
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
    nvcc = find_nvcc()
    # build under a temporary directory and name, then rename: concurrent
    # processes never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        procs = []
        for src in sources():
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", os.path.join(work, src.stem + ".o"),
                   str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, lib.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(os.path.join(work, src.stem + ".o") for src in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(log) + proc.stdout + proc.stderr)
        os.replace(tmp, lib)
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


def check_tensor(what: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Validate one kernel argument of a fixed shape (a plane stack or a
    padded slab): on ``device``, float32, ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{what}: all tensors must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: tensors must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous")
