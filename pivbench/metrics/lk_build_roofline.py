"""The least time the card could take for dense Lucas-Kanade's shift-plane
builds (K6, 2 x 121 planes a solve) that the window's pairs needed
(``pivbench/lk_work.py``, at the reference's counts), over the device time
of the stage's kernels (``stages/lk_build/``), %."""

from pivbench import lk_work
from pivbench.trace import stage_ns

STAGE = "lk_build"


def read(ctx):
    ns = stage_ns(ctx, STAGE)
    least = lk_work.stage_least_seconds(STAGE, ctx["entries"])
    if not ns or not least:
        return None
    return 100.0 * least / (ns / 1e9)
