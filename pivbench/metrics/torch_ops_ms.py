"""Device time of everything that is not one of the port's hand kernels
(the stages' kernel names) nor a host copy: PyTorch's elementwise kernels,
reductions, gathers, matrix products, device-to-device copies and sets,
per pair, ms."""

from pivbench.trace import matches


def read(ctx):
    hand = ctx["hand_kernels"]
    ns = sum(o.end - o.start for o in ctx["ops"]
             if o.kind not in ("htod", "dtoh") and not any(matches(o.name, k) for k in hand))
    if not ns or not ctx["pairs"]:
        return None
    return ns / 1e6 / ctx["pairs"]
