"""PointMLP's per-cloud standard deviations' own device time: work
launched inside the port's span ``iq_group_std`` (each stage's gathered
differences and ``torch.std`` over each cloud's, plain PyTorch), as a share
of the device's busy time (moves ``forwards_per_s``).  None where the port
has no such span."""

GROUP_STD = "iq_group_std"


def read(ctx):
    t = ctx.trace
    if GROUP_STD not in t.spans or t.busy_s <= 0:
        return None
    device_s = t.device_s([GROUP_STD])
    return None if device_s is None else 100.0 * device_s / t.busy_s
