"""Kernel 10 (``iq_knn_group_max``: PCT's sample-and-group layer after the
kNN, the gathered rows' layer-1 ReLU, layer 2 with its folded BatchNorm and
ReLU, and the max over each centre's group) against its roofline: the least
time the window's launches need, over the device time launched in its
spans (moves ``forwards_per_s``).

The least time of one level's launch over B clouds, S centres of K slots,
a database of N rows, layer widths C1, C2, is the larger of
  * bytes, each once: the kNN indices (B S K), the hoisted layer-1 rows u
    (B N C1), the centres' share c (B S C1), layer 2's weights (C1 C2) and
    its folded BatchNorm shift (C2), and the (B, S, C2) output, at the HBM
    rate;
  * layer 2, C1 C2 multiply-adds on every distinct slot of every distinct
    centre (``work``'s ``groups``), as three TF32 passes (the split that
    keeps f32 accuracy) at the TF32 rate.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.  None where the trace holds no kernel
10 span.
"""
from iqbench.reference.pct import LEVELS

K10_SPAN = "iq_knn_group_max"


def launch_seconds(B, S, K, N, widths, slots, peaks) -> float:
    C1, C2 = widths
    nbytes = 4.0 * (B * S * K + B * N * C1 + B * S * C1 + C1 * C2 + C2
                    + B * S * C2)
    tc = 2.0 * slots * C1 * C2
    return max(nbytes / peaks["hbm_bytes_per_s"],
               peaks["tf32_passes_for_f32"] * tc / peaks["tf32_flops_per_s"])


def read(ctx):
    device_s = ctx.trace.device_s([K10_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg, bound = ctx.cfg, 0.0
    for e in ctx.work():
        N = cfg["num_points"]
        for level in LEVELS:
            spec = cfg[level]
            bound += e["forwards"] * launch_seconds(
                e["clouds"], spec["npoint"], spec["nsample"], N, spec["mlp"],
                e["groups"][level]["slots"], ctx.peaks)
            N = spec["npoint"]
    return 100.0 * bound / device_s
