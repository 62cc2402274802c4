"""ctypes bindings for the native IO runtime (``ofri_io.cpp``).

``ofri_io.cpp`` is a copy of the JAX package's
``utils/native/ofri_io.cpp`` (``tests/test_torch_io.py`` holds the two
byte-identical): an uncompressed 8/16-bit grayscale TIFF decoder straight to
float32, a threaded batch decoder and a MAT-5 flow writer.  It is built with
``g++`` at first use (about a second) into ``build/opticalflow_ri_tpu_torch/``
beside the package, under a name keyed by a hash of the source, never at
import.  Without a toolchain ``available()`` is False and ``utils/io.py``
falls back to PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ofri_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "opticalflow_ri_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libofri_io_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless a library for this source exists; returns
    its path.  Builds under a temporary name and renames, so concurrent
    processes never load a half-written library."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, lib.name)
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def _load():
    """The loaded library, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.ofri_tiff_read.restype = ctypes.c_int
    lib.ofri_tiff_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ofri_tiff_read_batch.restype = ctypes.c_int
    lib.ofri_tiff_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ofri_save_flow.restype = ctypes.c_int
    lib.ofri_save_flow.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def tiff_read(path: str) -> np.ndarray | None:
    """Decode an uncompressed grayscale TIFF to float32; None if the file is
    missing or its layout unsupported (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.ofri_tiff_read(path.encode(), None, 0, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.ofri_tiff_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.size,
                            ctypes.byref(h), ctypes.byref(w))
    return out if rc == 0 else None


def tiff_read_batch(paths) -> np.ndarray | None:
    """Threaded decode of equally sized TIFFs into one (N, H, W) float32
    array; None if any file cannot be decoded natively."""
    lib = _load()
    if lib is None or not paths:
        return None
    first = tiff_read(paths[0])
    if first is None:
        return None
    h, w = first.shape
    out = np.empty((len(paths), h, w), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ofri_tiff_read_batch(arr, len(paths), out.ctypes.data_as(ctypes.c_void_p), h, w)
    return out if rc == 0 else None


def save_flow(path: str, u: np.ndarray, v: np.ndarray) -> bool:
    """Write the flow in the MAT-5 schema of ``utils/io.save_flow``; False
    where the runtime is unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    u = np.ascontiguousarray(u, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    rc = lib.ofri_save_flow(path.encode(), u.ctypes.data_as(ctypes.c_void_p),
                            v.ctypes.data_as(ctypes.c_void_p), u.shape[0], u.shape[1])
    return rc == 0
