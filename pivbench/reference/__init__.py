"""The benchmark's plain reference: the coarse-to-fine pyramid and its
solvers in plain PyTorch, on blocks of pairs (N, H, W), float32 with TF32
off, or in the lower precision of a control (``glue.PRECISIONS``).

A configuration file's ``pipeline`` names the recipe: the prefilter sigma,
the levels, the refiner's prefilter, and the solvers by module name in this
package with their parameters (``horn_schunck``, ``liu_shen``,
``farneback``); a new solver is a new module with a ``Solver`` class.  This
package imports nothing of the program under test.

    u, v, tally = pipeline(im1, im2, recipe)

``tally`` lists each solver call: its stage, its level shape and the
iterations or steps each pair ran, which the roofline metrics count.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from pivbench.reference import glue


def solver(spec: dict, levels: int, prec: glue.Precision):
    """The ``Solver`` of module ``spec["solver"]`` built on ``spec``."""
    mod = importlib.import_module(f"pivbench.reference.{spec['solver']}")
    return mod.Solver(spec, levels, prec)


def _next_level(im1, im2, prev_hw, u_acc, v_acc, warping, scale, mm):
    """Carry the accumulated flow to a new level: upsampled, scaled, and
    either warping the pair (the increments start at 0) or handed to the
    solver as its start (the accumulators restart at 0)."""
    h, w = im1.shape[-2:]
    ph, pw = prev_hw
    us, vs = glue.upsample(u_acc, (h, w), mm), glue.upsample(v_acc, (h, w), mm)
    if scale:
        us = us * float(np.float32(w) / np.float32(pw))
        vs = vs * float(np.float32(h) / np.float32(ph))
    zeros = torch.zeros_like(im1)
    if warping:
        im1, im2 = glue.warp_pair(im1, im2, us, vs)
        return im1, im2, us, vs, zeros, zeros
    return im1, im2, zeros, zeros, us, vs


def pipeline(im1: torch.Tensor, im2: torch.Tensor, recipe: dict, precision: str = "fp32"):
    """(U, V, tally) of the recipe on (N, H, W) float32 stacks."""
    prec = glue.PRECISIONS[precision]
    mm = prec.matmul
    levels = int(recipe.get("pyr_levels", 1))
    if int(recipe.get("k_levels", 1)) != 1:
        raise NotImplementedError("the reference runs one solve a level (k_levels = 1)")
    main = solver(recipe["main"], levels, prec)
    opt = solver(recipe["optional"], levels, prec) if recipe.get("optional") else None
    sigma = float(recipe.get("filter_sigma", 0.0))
    sigma_opt = recipe.get("filter_opt")
    flags = {"warping": True, "biLinear": True, "intermediateScaling": True, "scaling": False}
    flags.update(main.defaults or {})
    if not flags["biLinear"]:
        raise NotImplementedError("the reference warps bilinearly (biLinear=True) only")
    im1, im2 = im1.to(torch.float32), im2.to(torch.float32)
    h, w = im1.shape[-2:]
    tally: list = []
    scale = 1.0 / 2.0 ** (levels - 1)
    u_acc = v_acc = u = v = prev = None
    with glue.tf32(False):
        for level in range(1, levels + 1):
            if scale < 1.0 and level != levels:
                size = (int(np.round(h * scale)), int(np.round(w * scale)))
                a = glue.resize(im1, size, "bicubic", mm)
                b = glue.resize(im2, size, "bicubic", mm)
            else:
                a, b = im1, im2
            if level > 1:
                local = flags["scaling"] if level == levels else flags["intermediateScaling"]
                wa, wb, u_acc, v_acc, u, v = _next_level(a, b, prev, u_acc, v_acc,
                                                         flags["warping"], local, mm)
            else:
                wa, wb = a, b
                u = v = u_acc = v_acc = torch.zeros_like(a)
            if sigma > 1e-3:
                wa, wb = glue.prefilter(wa, sigma, 3), glue.prefilter(wb, sigma, 3)
            u, v = main.compute(wa, wb, u, v, tally)
            if opt is not None:
                oa, ob = ((glue.prefilter(a, float(sigma_opt), 5), glue.prefilter(b, float(sigma_opt), 5))
                          if sigma_opt is not None and float(sigma_opt) > 1e-3 else (a, b))
                u, v = opt.compute(oa, ob, u, v, tally)
            u_acc, v_acc = u_acc + u, v_acc + v
            prev = wa.shape[-2:]
            scale *= 2
    return u_acc, v_acc, tally
