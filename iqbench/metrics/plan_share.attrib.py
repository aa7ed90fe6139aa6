"""The plan's own device time: work launched inside the port's plan spans
(``iq_plan``: the pose-invariant graphs or FPS indices built once per chunk
of masked clouds), as a share of the device's busy time (moves
``forwards_per_s``).  None where the port has no such span."""

PLAN = "iq_plan"


def read(ctx):
    t = ctx.trace
    if PLAN not in t.spans or t.busy_s <= 0:
        return None
    plan = t.device_s([PLAN])
    return None if plan is None else 100.0 * plan / t.busy_s
