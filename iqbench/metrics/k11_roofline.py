"""Kernel 11 (``iq_group_res_mlp``: a PointMLP stage's grouped layers after
the kNN and the standard deviation: the gathers, the hoisted transfer's
ReLU, two residual blocks of two layers and the max over each centre's
group) against its roofline: the least time the window's launches need,
over the device time launched in its spans (moves ``forwards_per_s``).

The least time of one stage's launch over B clouds, S centres of K slots,
a database of N rows and width C is the larger of
  * bytes, each once: the kNN indices (B S K) and the centres' own rows
    (B S), the hoisted transfer rows u (B N C), the centres' share c
    (B S C), each cloud's scale (B), the four C x C products and their
    folded BatchNorm shifts (4 C^2 + 4 C), and the (B, S, C) output, at the
    HBM rate;
  * the four products, 4 C^2 multiply-adds on every distinct slot of every
    distinct centre (``work``'s ``stages``), as three TF32 passes (the
    split that keeps f32 accuracy) at the TF32 rate.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.  None where the trace holds no kernel
11 span.
"""
K11_SPAN = "iq_group_res_mlp"


def launch_seconds(B, S, K, N, C, slots, peaks) -> float:
    nbytes = 4.0 * (B * S * K + B * S + B * N * C + B * S * C + B
                    + 4 * C * C + 4 * C + B * S * C)
    tc = 2.0 * slots * 4 * C * C
    return max(nbytes / peaks["hbm_bytes_per_s"],
               peaks["tf32_passes_for_f32"] * tc / peaks["tf32_flops_per_s"])


def read(ctx):
    device_s = ctx.trace.device_s([K11_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg, bound = ctx.cfg, 0.0
    for e in ctx.work():
        N = cfg["num_points"]
        for spec, counts in zip(cfg["stages"], e["stages"]):
            bound += e["forwards"] * launch_seconds(
                e["clouds"], spec["anchors"], spec["k"], N, spec["width"],
                counts["slots"], ctx.peaks)
            N = spec["anchors"]
    return 100.0 * bound / device_s
