"""The yardstick of the roofline metrics: the card's published peaks and
the least work each stage's calls need.

A call's least time is the larger of its bytes over the memory rate and its
float operations over the float32 rate outside the tensor cores, with each
input read once and each output written once, whatever a kernel reads
again; a stage's least time is the sum over its calls.  The counts follow
the arithmetic of the stage as the reference computes it, at the
iterations or steps each pair needed (the reference's tally), so they read
the same whatever implements the stage.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def hs_iterate(n: int, iters: int, **_) -> tuple:
    """Horn-Schunck: fx, fy, ft, u0, v0 in, u, v out; 27 operations a pixel an
    iteration (two neighbour averages, the update) and 5 for the
    reciprocal."""
    return 28 * n, (27 * iters + 5) * n


def ls_iterate(n: int, iters: int, **_) -> tuple:
    """Liu-Shen: the eight fields and u0, v0 in, u, v out; 68 operations a
    pixel a step."""
    return 48 * n, 68 * iters * n


def fb_iterate(n: int, iters: int, taps: int = 33, **_) -> tuple:
    """Farnebäck's rounds: R0, R1 (five planes each) and the start flow in,
    the flow out; a round is updateMatrices (~100 operations a pixel) and
    the window blur of five planes, two passes of a product and a sum a
    tap, with the 2x2 solve (15)."""
    return 56 * n, iters * (100 + 5 * 2 * 2 * taps + 15) * n


WORK = {"hs_iterate": hs_iterate, "ls_iterate": ls_iterate, "fb_iterate": fb_iterate}


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def stage_least_seconds(stage: str, entries: list) -> float:
    """The least time of a stage's calls: ``entries`` are tally entries
    ({"stage", "shape", "count", ...}), one a call of one pair."""
    fn = WORK[stage]
    total = 0.0
    for e in entries:
        if e["stage"] != stage:
            continue
        h, w = e["shape"]
        total += least_seconds(*fn(h * w, e["count"], **e.get("params", {})))
    return total


def stage_ops(entries: list) -> float:
    """The float operations of every counted stage call in ``entries``."""
    return sum(WORK[e["stage"]](e["shape"][0] * e["shape"][1], e["count"],
                                **e.get("params", {}))[1]
               for e in entries if e["stage"] in WORK)
