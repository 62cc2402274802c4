"""Device time of the host-to-device and device-to-host copies, per pair, ms."""


def read(ctx):
    ns = sum(o.end - o.start for o in ctx["ops"] if o.kind in ("htod", "dtoh"))
    if not ns or not ctx["pairs"]:
        return None
    return ns / 1e6 / ctx["pairs"]
