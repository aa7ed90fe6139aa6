"""The whole forward's share of the card's TF32 peak in the attribution
cells: the products the window's forwards and plans needed, over the
window, over 495 TFLOP/s (moves ``forwards_per_s``).

TF32's rate is the fastest at which the card can give the configurations'
f32-accurate products (three passes of the split; counted once here, so
the share reads as against the peak of one pass, the usual MFU).
Products are counted as the inputs need them, whatever computes them, 2
operations a multiply-add, on each cloud's distinct points
(``work.distinct_points``) and the family's own counts: the configuration's
reference module's ``flops`` says what it counts.  Elementwise work
(BatchNorm, activations, maxima) is not counted.
"""
from iqbench.reference import attribution as ref_attr


def read(ctx):
    if ctx.peaks is None:
        return None
    family = ref_attr.model(ctx.cfg)
    flops = sum(family.flops(ctx.cfg, e) for e in ctx.work())
    return 100.0 * flops / ctx.window_s / ctx.peaks["tf32_flops_per_s"]
