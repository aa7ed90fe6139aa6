"""Kernel 7 (``iq_pointconv_sa``: PointConv's set abstraction after the
kNN, layers 2-3 of the MLP scaled by DensityNet's output, WeightNet and the
contraction over the neighbours) against its roofline: the least time the
window's launches need, over the device time launched in its spans (moves
``forwards_per_s``).

The least time of one level's launch over B clouds, S centres of K slots,
a database of N rows, layer widths C1, C2, C3, is the largest of
  * bytes, each once: the kNN indices and the density scale (B S K each),
    the centres (B S 3), the hoisted layer-1 rows u (B N C1), xyz (B N 3),
    the centres' share csw (B S C1), the weights of layers 2-3 and
    WeightNet, and the (B, S, 16 C3) output, at the HBM rate;
  * layers 2 and 3 and the contraction, C1 C2 + C2 C3 + 16 C3 multiply-adds
    on every distinct slot of every distinct centre (``work``'s
    ``groups``), as three TF32 passes (the split that keeps f32 accuracy)
    at the TF32 rate;
  * WeightNet, 3 x 8 + 8 x 8 + 8 x 16 multiply-adds a distinct slot, on the
    f32 units.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.
"""
from iqbench.reference.pointconv import LEVELS, net_macs

K7_SPAN = "iq_pointconv_sa"


def launch_seconds(B, S, K, N, widths, wnet, slots, peaks) -> float:
    C1, C2, C3 = widths
    wo = wnet[-1]
    weights = C1 * C2 + C2 + C2 * C3 + C3 + net_macs(wnet, 3) + sum(wnet)
    nbytes = 4.0 * (2 * B * S * K + B * S * 3 + B * N * (C1 + 3) + B * S * C1
                    + weights + B * S * wo * C3)
    tc = 2.0 * slots * (C1 * C2 + C2 * C3 + wo * C3)
    f32 = 2.0 * slots * net_macs(wnet, 3)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               f32 / peaks["f32_flops_per_s"],
               peaks["tf32_passes_for_f32"] * tc / peaks["tf32_flops_per_s"])


def read(ctx):
    device_s = ctx.trace.device_s([K7_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg, bound = ctx.cfg, 0.0
    for e in ctx.work():
        N = cfg["num_points"]
        for level in LEVELS:
            spec = cfg[level]
            bound += e["forwards"] * launch_seconds(
                e["clouds"], spec["npoint"], spec["nsample"], N, spec["mlp"],
                cfg["weightnet"], e["groups"][level]["slots"], ctx.peaks)
            N = spec["npoint"]
    return 100.0 * bound / device_s
