"""The share of the traced window in which nothing ran on the device: 1 -
the union of its kernels, copies and sets over the window's wall time, %."""


def read(ctx):
    lo, hi = ctx["window"]
    if not ctx["ops"] or hi <= lo:
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / (hi - lo))
