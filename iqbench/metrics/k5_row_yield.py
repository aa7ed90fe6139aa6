"""Kernel 5's row yield (``iq_ball_mlp3``): the rows the window's launches
needed through layers 2-3, over those the kernel multiplied (the port's
work counter ``k5_rows``: each centre's filled slots, without feature rows
the fresh ones, every centre counted, repeated ones too), as a share
(moves ``forwards_per_s``).

Needed: the distinct filled slots of each distinct centre, summed over the
branches of both levels (``work.ball_counts``' ``slots``, as
``k5_roofline`` sums them).
"""
from iqbench.port_counts import port_counter


def needed(entries) -> float:
    return float(sum(e["forwards"] * sum(sum(e["balls"][level]["slots"])
                                         for level in ("sa1", "sa2"))
                     for e in entries))


def read(ctx):
    done = port_counter("k5_rows")
    if not done:
        return None
    return 100.0 * needed(ctx.work()) / done
