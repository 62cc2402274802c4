"""The least work of dense Lucas-Kanade's two stages, for their roofline
metrics, in the terms of ``pivbench/work.py`` (each input read once, each
output written once; bytes at 3.35 TB/s, float32 operations at 67 TFLOP/s),
at the reference's counts (``reference/lucas_kanade.py``'s tally), at the
shift radius R = 5 and the 27-sample window of the configurations:

  ``lk_build``    the J slab (h + 41)(w + 41) and the gradient pair
                  2 (h + 31)(w + 31) in, the 2 x 121 planes of (h, w) out;
                  13 operations a plane pixel, a product and the window's
                  two passes as a ladder of 6 adds each (the stage is
                  bound by its bytes either way);
  ``lk_iterate``  the five fields, the mask and the two origins in (32 B a
                  pixel) and px, py, status out (12 B), the values of both
                  planes at the four integer shifts that enclose a pixel's
                  displacement (32 B), read once, and ~60 operations a step,
                  s the steps a pixel ran on average.  A later step between
                  the same shifts reads those values again, which is not
                  counted, and one that moves to new shifts reads at most
                  two more of each plane, which the tally does not keep, so
                  the count is exact for a pixel whose displacement stays
                  between one set of shifts and the least for the others.
"""

from __future__ import annotations

from pivbench import work


def lk_build(h: int, w: int, count: float = 1, **_) -> tuple:
    slab = (h + 41) * (w + 41)
    core = (h + 31) * (w + 31)
    n = h * w
    return count * 4 * (slab + 2 * core + 2 * 121 * n), count * 2 * 121 * 13 * n


def lk_iterate(h: int, w: int, count: float = 0, **_) -> tuple:
    n = h * w
    return (44 + (32 if count > 0 else 0)) * n, 60 * count * n


WORK = {"lk_build": lk_build, "lk_iterate": lk_iterate}


def stage_least_seconds(stage: str, entries: list) -> float:
    """The least time of the stage's calls among the tally ``entries``."""
    fn = WORK[stage]
    return sum(work.least_seconds(*fn(*e["shape"], e["count"], **e.get("params", {})))
               for e in entries if e["stage"] == stage)
