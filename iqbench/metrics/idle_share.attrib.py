"""Share of the traced window in which no operation ran on the device, in
the attribution cells (moves ``forwards_per_s``)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
