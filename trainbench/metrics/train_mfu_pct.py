"""Model FLOPs of the window's steps (``counts.step_flops``) over the
window's wall time times the chip's bf16 dense peak."""

UNIT = "%"


def read(ctx):
    c = ctx["counts"]
    flops = ctx["n_steps"] * c.step_flops(ctx["spec"], ctx["mix"])
    return 100.0 * flops / (ctx["window_s"] * c.PEAK_BF16_FLOPS)
