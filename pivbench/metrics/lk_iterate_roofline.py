"""The least time the card could take for dense Lucas-Kanade's Gauss-Newton
steps (K7) on the shift planes that the window's pairs needed
(``pivbench/lk_work.py``, at the reference's counts), over the device time
of the stage's kernels (``stages/lk_iterate/``), %."""

from pivbench import lk_work
from pivbench.trace import stage_ns

STAGE = "lk_iterate"


def read(ctx):
    ns = stage_ns(ctx, STAGE)
    least = lk_work.stage_least_seconds(STAGE, ctx["entries"])
    if not ns or not least:
        return None
    return 100.0 * least / (ns / 1e9)
