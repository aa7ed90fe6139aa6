"""Kernel 7's slot yield (``iq_pointconv_sa``): the slots the window's
forwards needed through layers 2-3 and the contraction, over those kernel
7 multiplies at its launched shapes (B x S x K a level and forward: every
centre and slot, repeated ones too), as a share (moves
``forwards_per_s``).  None where the trace holds no kernel 7 span.

Needed: the distinct slots of each distinct centre, summed over both SA
levels (``work``'s ``groups``, as ``k7_roofline`` counts them).  A kernel
that skipped repeated slots would need its own count of what it did, as
kernel 5 keeps ``k5_rows``.
"""
from iqbench.reference.pointconv import LEVELS

K7_SPAN = "iq_pointconv_sa"


def needed(entries) -> float:
    return float(sum(e["forwards"] * sum(e["groups"][level]["slots"]
                                         for level in LEVELS)
                     for e in entries))


def launched(cfg, entries) -> float:
    per_cloud = sum(cfg[level]["npoint"] * cfg[level]["nsample"]
                    for level in LEVELS)
    return float(sum(e["forwards"] * e["clouds"] * per_cloud for e in entries))


def read(ctx):
    if K7_SPAN not in ctx.trace.spans:
        return None
    entries = ctx.work()
    done = launched(ctx.cfg, entries)
    return 100.0 * needed(entries) / done if done else None
