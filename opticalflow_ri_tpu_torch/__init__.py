"""opticalflow_ri_tpu_torch — the PyTorch/CUDA port of opticalflow_ri_tpu.

The JAX package ``opticalflow_ri_tpu`` is the reference; this package mirrors
its module layout (``pyramid``, ``configs``, ``models.horn_schunck``,
``ops.*``) so each function has a counterpart of the same name.  Plain tensor
code is PyTorch; every Pallas TPU kernel on a ported path is a hand-written
CUDA kernel for Hopper under ``csrc/``, built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/cuda/build.py``).  A kernel wrapper launches its
kernel for CUDA tensors and runs its plain PyTorch version for CPU tensors.

Ported so far: the Horn-Schunck pyramidal main path (calibrated Gaussian
prefilter, HS derivative stencils and Jacobi solve, PIL-bicubic downsizing,
spline flow upsampling, symmetric bilinear warp).  This package never imports
jax.

Images and flows are ``(H, W)`` float32 tensors; adapters follow the
reference protocol ``compute(im1, im2, U, V) -> (U, V, err)``.
"""

import torch

# FP32 pins: the resize matmuls apply calibrated weights (the JAX package runs
# them at Precision.HIGHEST), so TF32 must never stand in for float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from opticalflow_ri_tpu_torch.pyramid import (  # noqa: E402
    generic_pyramidal_optical_flow,
    GenericPyramidalOpticalFlowWrapper,
)
from opticalflow_ri_tpu_torch.models.horn_schunck import HSOpticalFlowAlgoAdapter  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "generic_pyramidal_optical_flow",
    "GenericPyramidalOpticalFlowWrapper",
    "HSOpticalFlowAlgoAdapter",
]
