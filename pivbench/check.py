"""``correct``: the flows the timed path fetched, held against the plain
reference's flows of the same pairs.

For each compared pair the reference (``pivbench.reference``, float32 with
TF32 off) runs on the pool's host frames; the numbers are
  ``flow_aee_px``  the worst pair's mean endpoint error, px;
  ``flow_max_px``  the largest |du| or |dv| over every pixel of every pair.
A configuration's ``limits`` name the numbers it compares and their limits,
set between the readings of sound runs and of the control, the reference
in the precision below (``control``); ``PERF.md`` gives the readings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pivbench.reference import pipeline

NUMBERS = ("flow_aee_px", "flow_max_px")


def reference_flows(cfg: dict, im1s: np.ndarray, im2s: np.ndarray, indices, device,
                    precision: str = "fp32"):
    """Yields (index, U, V, tally entries) of each pool index, the reference
    run in blocks of ``cfg["reference_block"]`` pairs on ``device``; U and V
    stay on the device."""
    block = int(cfg.get("reference_block", 8))
    indices = sorted(indices)
    for s in range(0, len(indices), block):
        idx = indices[s:s + block]
        a = torch.from_numpy(im1s[idx]).to(device)
        b = torch.from_numpy(im2s[idx]).to(device)
        u, v, tally = pipeline(a, b, cfg["pipeline"], precision)
        for j, i in enumerate(idx):
            entries = [{"stage": t["stage"], "shape": tuple(t["shape"]), "count": t["counts"][j],
                        "params": t.get("params", {})} for t in tally]
            yield i, u[j], v[j], entries
        del a, b, u, v


def compare(flows: dict, ref) -> dict:
    """The numbers of ``flows`` ({pool index: (u, v)}, host or device arrays)
    against ``ref`` (the items of ``reference_flows``): {name: value}, with
    ``pairs`` compared and the reference's ``tally`` by index."""
    aee, mx, tally = [], [], {}
    for i, ru, rv, entries in ref:
        tally[i] = entries
        if i not in flows:
            continue
        u, v = (torch.as_tensor(x).to(ru.device) for x in flows[i])
        du, dv = u - ru, v - rv
        aee.append(float(torch.hypot(du, dv).mean()))
        mx.append(float(torch.maximum(du.abs().max(), dv.abs().max())))
    return {"flow_aee_px": worst(aee), "flow_max_px": worst(mx), "pairs": len(aee),
            "tally": tally}


def worst(values: list) -> float:
    """The largest value, NaN if any is NaN."""
    return math.nan if any(math.isnan(x) for x in values) else max(values, default=0.0)


def verdict(cfg: dict, numbers: dict, expected: int) -> tuple:
    """(correct, checks): each number the configuration limits beside its
    limit; a number that is not finite, or fewer pairs compared than were
    kept, is not correct."""
    limits = cfg["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    checks["pairs_compared"] = {"value": numbers["pairs"], "limit": expected}
    ok = numbers["pairs"] == expected and expected > 0 and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS if k in limits)
    return ok, checks
