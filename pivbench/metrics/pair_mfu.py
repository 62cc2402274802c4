"""The whole pair's share of the card's float32 peak: the operations of
every counted stage (Horn-Schunck iterations, Liu-Shen steps, Farnebäck
rounds, at the reference's counts) over the traced window's wall time at
67 TFLOP/s, %.  Operations outside those stages are not counted, so this
is a lower bound."""


def read(ctx):
    lo, hi = ctx["window"]
    ops = ctx["work"].stage_ops(ctx["entries"])
    if not ops or not ctx["ops"] or hi <= lo:
        return None
    return 100.0 * ops / ((hi - lo) / 1e9 * ctx["work"].FP32_OPS_PER_S)
