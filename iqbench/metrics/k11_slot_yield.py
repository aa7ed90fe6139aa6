"""Kernel 11's slot yield (``iq_group_res_mlp``): the slots the window's
forwards needed through the four products, over those kernel 11 ran
(the port's work counter ``k11_slots``: B x S x K a launch, every centre
and slot, repeated ones too), as a share (moves ``forwards_per_s``).  None
where the port keeps no such counter.

Needed: the distinct slots of each distinct centre, summed over the four
stages (``work``'s ``stages``, as ``k11_roofline`` counts them).
"""
from iqbench.port_counts import port_counter


def needed(entries) -> float:
    return float(sum(e["forwards"] * sum(counts["slots"]
                                         for counts in e["stages"])
                     for e in entries))


def read(ctx):
    done = port_counter("k11_slots")
    if not done:
        return None
    return 100.0 * needed(ctx.work()) / done
