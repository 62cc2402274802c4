"""The least time the card could take for the Farnebäck rounds (updateMatrices and the window blur with the solve) that the window's
pairs needed (``pivbench/work.py``, at the reference's counts), over the
device time of the stage's kernels (``stages/fb_iterate/``), %."""

from pivbench.trace import stage_ns

STAGE = "fb_iterate"


def read(ctx):
    ns = stage_ns(ctx, STAGE)
    least = ctx["work"].stage_least_seconds(STAGE, ctx["entries"])
    if not ns or not least:
        return None
    return 100.0 * least / (ns / 1e9)
