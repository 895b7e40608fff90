"""Share of the traced stretch in which no operation ran on the card."""

UNIT = "%"


def read(ctx):
    tl = ctx["timeline"]
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
