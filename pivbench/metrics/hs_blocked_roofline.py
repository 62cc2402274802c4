"""The least time the card could take for the Horn-Schunck iterations that the
window's pairs needed (``pivbench/work.py``, at the reference's counts), over
the device time of the stage's kernels (``stages/hs_iterate/``), %: the
yardstick of ``hs_iterate_roofline``, read in the cells whose every K1 solve
is too large for the resident path, so that it reads K1's blocked path."""

from pivbench.trace import stage_ns

STAGE = "hs_iterate"


def read(ctx):
    ns = stage_ns(ctx, STAGE)
    least = ctx["work"].stage_least_seconds(STAGE, ctx["entries"])
    if not ns or not least:
        return None
    return 100.0 * least / (ns / 1e9)
