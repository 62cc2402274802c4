"""Whole-config pipeline callables (port of ``compile.py:29-45``).

PyTorch runs eagerly, so a "compiled" pipeline is the plain callable: the
Hopper kernels already carry the hot loops.  Capturing a pipeline in a CUDA
graph, and the on-device stream ``scan_pipeline``, come in later work
(ROADMAP.md Queue 1, item 7).

    fn = compiled_pipeline("PyHSchunck_Fs3_4")
    U, V = fn(im1, im2)
"""

from __future__ import annotations

from opticalflow_ri_tpu_torch.configs import build_config


def pipeline_fn(name: str):
    """An (im1, im2, device="cuda") -> (U, V) function for a named calibrated
    config.  Each call builds fresh adapters, so alpha lists start full."""
    cfg = build_config(name)

    def fn(im1, im2, device="cuda"):
        return cfg.run(im1, im2, device=device)

    return fn


def compiled_pipeline(name: str):
    """The pipeline callable for ``name`` (eager; see the module docstring)."""
    return pipeline_fn(name)
