"""The least time the card could take for the Liu-Shen steps that the window's
pairs needed (``pivbench/work.py``, at the reference's counts), over the
device time of the stage's kernels (``stages/ls_iterate/``), %."""

from pivbench.trace import stage_ns

STAGE = "ls_iterate"


def read(ctx):
    ns = stage_ns(ctx, STAGE)
    least = ctx["work"].stage_least_seconds(STAGE, ctx["entries"])
    if not ns or not least:
        return None
    return 100.0 * least / (ns / 1e9)
