"""Kernel 9 (``iq_dense_pool``: DGCNN's head, conv5 with its eval
BatchNorm and LeakyReLU, then the max and the mean over the points)
against its roofline: the least time the window's launches need, over the
device time launched in its spans (moves ``forwards_per_s``).

The least time of a launch over B clouds of N rows, K channels in
(the edge convs' widths), C out (``emb_dims``), each cloud with d
distinct rows (``work.distinct_points``), is the largest of
  * bytes: the input rows, W, the BatchNorm's four vectors and the
    (B, 2C) output, each once, 4 (B N K + K C + 4 C + 2 B C), at the HBM
    rate;
  * the products on each cloud's distinct rows, 2 K C d, as three TF32
    passes (the split that keeps f32 accuracy) at the TF32 rate;
  * on the f32 units, the epilogue's compare (the max) and add (the sum),
    2 C a distinct row.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.
"""

K9_SPAN = "iq_dense_pool"


def launch_seconds(B, N, K, C, sum_d, peaks) -> float:
    nbytes = 4.0 * (B * N * K + K * C + 4 * C + 2 * B * C)
    tc = 2.0 * K * C * sum_d
    f32 = 2.0 * C * sum_d
    return max(nbytes / peaks["hbm_bytes_per_s"],
               f32 / peaks["f32_flops_per_s"],
               peaks["tf32_passes_for_f32"] * tc / peaks["tf32_flops_per_s"])


def read(ctx):
    device_s = ctx.trace.device_s([K9_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg = ctx.cfg
    K, C = sum(cfg["edge_widths"]), cfg["emb_dims"]
    bound = sum(e["forwards"] * launch_seconds(
        e["clouds"], cfg["num_points"], K, C, e["d"].astype(float).sum(),
        ctx.peaks) for e in ctx.work())
    return 100.0 * bound / device_s
