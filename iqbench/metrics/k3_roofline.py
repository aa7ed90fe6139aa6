"""Kernel 3 (``iq_knn_gather_extrema``: kNN in feature space, then the max
and min of the neighbours' rows) against its roofline: the least time the
window's launches need, over the device time launched in its spans
(moves ``forwards_per_s``).

The least time of a launch over B clouds of N rows, C channels in, F out,
k neighbours, each cloud with d distinct rows (``work.distinct_points``),
is the largest of
  * bytes: the rows and values read once, both extrema written once,
    4 B N (C + 3F), at the HBM rate;
  * the distances' inner products, 2 C d^2 a cloud, as three TF32 passes
    (the split that keeps f32 accuracy) at the TF32 rate;
  * on the f32 units, 3 operations a distance (two adds, one compare) and
    the extrema's 2 k F compares a distinct row.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.
"""

K3_SPAN = "iq_knn_gather_extrema"


def launch_seconds(B, N, C, F, k, sum_d, sum_d2, peaks) -> float:
    nbytes = 4.0 * B * N * (C + 3 * F)
    tc = 2.0 * C * sum_d2
    f32 = 3.0 * sum_d2 + 2.0 * k * F * sum_d
    return max(nbytes / peaks["hbm_bytes_per_s"],
               f32 / peaks["f32_flops_per_s"],
               peaks["tf32_passes_for_f32"] * tc / peaks["tf32_flops_per_s"])


def read(ctx):
    device_s = ctx.trace.device_s([K3_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg = ctx.cfg
    widths = cfg["edge_widths"]
    c_in = [cfg["input_channels"]] + widths[:-1]
    bound = 0.0
    for entry in ctx.work():
        d = entry["d"].astype(float)
        first = 1 if entry["plans"] else 0      # a plan gives layer 1's graph
        for C, F in list(zip(c_in, widths))[first:]:
            bound += entry["forwards"] * launch_seconds(
                entry["clouds"], cfg["num_points"], C, F, cfg["k"], d.sum(),
                (d * d).sum(), ctx.peaks)
    return 100.0 * bound / device_s
