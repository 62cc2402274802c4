"""Image loading and PIV-tool-compatible flow persistence (port of
``utils/io.py``).

``save_flow`` writes the MATLAB schema of the reference's harness:
velocities{u, v, iaWidth, iaHeight, margins} + parameters{overlapFactor,
imageHeight, imageWidth}.  Uncompressed 8- and 16-bit grayscale TIFFs (the
PIV camera format) decode through the native runtime (``utils/native``), so
a campaign needs neither PIL nor matplotlib; PIL is imported only for a file
the native decoder does not take.
"""

from __future__ import annotations

import os

import numpy as np

from opticalflow_ri_tpu_torch.utils import native


def load_image(path) -> np.ndarray:
    """Load a grayscale image as float32, like the reference's
    ``skimage.io.imread(...).astype(np.float32)``."""
    path = str(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if path.lower().endswith((".tif", ".tiff")):
        arr = native.tiff_read(path)
        if arr is not None:
            return arr
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: not an uncompressed 8/16-bit grayscale TIFF, and PIL, "
                           f"which would decode it, is not installed") from e
    return np.asarray(Image.open(path), dtype=np.float32)


def load_image_batch(paths) -> np.ndarray:
    """Decode equally sized frames into one (N, H, W) float32 array: the
    native threaded decoder, else one ``load_image`` a frame."""
    paths = [str(p) for p in paths]
    arr = native.tiff_read_batch(paths)
    if arr is not None:
        return arr
    return np.stack([load_image(p) for p in paths])


def save_flow(U, V, filename) -> None:
    import scipy.io

    U = np.asarray(U)
    V = np.asarray(V)
    margins = {"top": 0, "left": 0, "bottom": 0, "right": 0}
    results = {"u": U, "v": V, "iaWidth": 1, "iaHeight": 1, "margins": margins}
    parameters = {
        "overlapFactor": 1.0,
        "imageHeight": U.shape[0],
        "imageWidth": U.shape[1],
    }
    scipy.io.savemat(filename, mdict={"velocities": results, "parameters": parameters})


def normalize_16bit_to_8bit(img: np.ndarray) -> np.ndarray:
    """16-bit to 8-bit range normalisation of the benchmark harness
    (ref: benchmark_of_methods.py:134-137)."""
    if img.max() > 255:
        return (img / 65535.0 * 255.0).astype(np.float32)
    return img.astype(np.float32)
