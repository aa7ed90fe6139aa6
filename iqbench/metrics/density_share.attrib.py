"""PointConv's KDE density's own device time: work launched inside the
port's span ``iq_density`` (``ops.geometry.compute_density``, each SA
level's and the last level's Gaussian KDE over the whole cloud, in the
plan), as a share of the device's busy time (moves ``forwards_per_s``).
None where the port has no such span."""

DENSITY = "iq_density"


def read(ctx):
    t = ctx.trace
    if DENSITY not in t.spans or t.busy_s <= 0:
        return None
    device_s = t.device_s([DENSITY])
    return None if device_s is None else 100.0 * device_s / t.busy_s
