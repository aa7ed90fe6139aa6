"""Kernel 10's slot yield (``iq_knn_group_max``): the slots the window's
forwards needed through layer 2, over those kernel 10 multiplied (the
port's work counter ``k10_slots``: B x S x K a launch, every centre and
slot, repeated ones too), as a share (moves ``forwards_per_s``).  None
where the port keeps no such counter.

Needed: the distinct slots of each distinct centre, summed over both
levels (``work``'s ``groups``, as ``k10_roofline`` counts them).
"""
from iqbench.port_counts import port_counter
from iqbench.reference.pct import LEVELS


def needed(entries) -> float:
    return float(sum(e["forwards"] * sum(e["groups"][level]["slots"]
                                         for level in LEVELS)
                     for e in entries))


def read(ctx):
    done = port_counter("k10_slots")
    if not done:
        return None
    return 100.0 * needed(ctx.work()) / done
