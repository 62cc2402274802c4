"""Hand-written Hopper kernels: the nvcc builder and one wrapper module per kernel.

Each wrapper launches its kernel for CUDA tensors (or raises), runs its plain
PyTorch version for CPU tensors, and counts its launches in a ``launches``
attribute.  Nothing here builds or loads a kernel at import time.
"""
