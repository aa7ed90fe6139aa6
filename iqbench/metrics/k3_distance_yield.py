"""Kernel 3's distance yield (``iq_knn_gather_extrema``): the distances the
window's launches needed, over those the kernel computed (the port's work
counter ``k3_distances``: per launch and cloud, its distinct query rows
times the database rows it scans), as a share (moves ``forwards_per_s``).

Needed: per cloud of d distinct points (``work.distinct_points``) d^2, in
every launch ``k3_roofline`` counts (layers 2-4 where a plan gives layer
1's graph, all four without).  A cloud with no collapsed point reads 100%.
"""
from iqbench.port_counts import port_counter


def needed(cfg, entries) -> float:
    layers = len(cfg["edge_widths"])
    total = 0.0
    for e in entries:
        d = e["d"].astype(float)
        launches = layers - (1 if e["plans"] else 0)
        total += e["forwards"] * launches * (d * d).sum()
    return total


def read(ctx):
    done = port_counter("k3_distances")
    if not done:
        return None
    return 100.0 * needed(ctx.cfg, ctx.work()) / done
