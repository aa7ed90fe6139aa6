"""Kernel 5 (``iq_ball_mlp3``: PointNet++'s ball query, its branch's three
layers and the max over the slots) against its roofline: the least time
the window's launches need, over the device time launched in its spans
(moves ``forwards_per_s``).

The least time of one branch's launch over B clouds, S centres, a database
of M rows, layer widths C1, C2, C3, is the largest of
  * bytes: database xyz, centres, the hoisted feature rows (C1 a row, at
    the levels with features) and the output, each once, at the HBM rate;
  * the products of every distinct slot of every distinct centre
    (``work.ball_counts``): the xyz offsets' 3 C1, C1 C2 and C2 C3
    multiply-adds, and at the level's first branch the distances of every
    distinct centre to every distinct database row (3 each), as three TF32
    passes (the split that keeps f32 accuracy) at the TF32 rate;
  * on the f32 units, the max's C3 compares a slot and one compare a
    distance.
Frozen: it counts what the inputs need, whatever the kernel does, so no
implementation can read over 100%.
"""

K5_SPAN = "iq_ball_mlp3"


def read(ctx):
    device_s = ctx.trace.device_s([K5_SPAN])
    if not device_s or ctx.peaks is None:
        return None
    cfg, p = ctx.cfg, ctx.peaks
    bound = 0.0
    for entry in ctx.work():
        B, db_rows, has_features = entry["clouds"], cfg["num_points"], False
        for level in ("sa1", "sa2"):
            spec, counts = cfg[level], entry["balls"][level]
            S = spec["npoint"]
            for b, (c1, c2, c3) in enumerate(spec["mlps"]):
                slots = counts["slots"][b]
                dist = counts["centres_db"] if b == 0 else 0
                nbytes = 4.0 * (B * db_rows * 3 + B * S * 3 + B * S * c3
                                + (B * db_rows * c1 if has_features else 0))
                tc = 2.0 * (slots * (3 * c1 + c1 * c2 + c2 * c3) + 3 * dist)
                f32 = slots * c3 + dist
                bound += entry["forwards"] * max(
                    nbytes / p["hbm_bytes_per_s"], f32 / p["f32_flops_per_s"],
                    p["tf32_passes_for_f32"] * tc / p["tf32_flops_per_s"])
            db_rows, has_features = S, True
    return 100.0 * bound / device_s
