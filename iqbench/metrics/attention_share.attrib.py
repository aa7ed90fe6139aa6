"""PCT's offset-attention layers' own device time: work launched inside the
port's span ``iq_offset_attention`` (each layer's projections, energy,
softmax, column normalisation, x_r and the output convolution, plain
PyTorch), as a share of the device's busy time (moves ``forwards_per_s``).
None where the port has no such span."""

ATTENTION = "iq_offset_attention"


def read(ctx):
    t = ctx.trace
    if ATTENTION not in t.spans or t.busy_s <= 0:
        return None
    device_s = t.device_s([ATTENTION])
    return None if device_s is None else 100.0 * device_s / t.busy_s
