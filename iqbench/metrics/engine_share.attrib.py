"""The engine's own device time: work launched inside the engine's call
(``iqbench.engine``: masking, plan-free glue, reward, marginals, the
logits' concatenation and copy) but outside the model's forwards
(``iqbench.forward``) and plans (``iqbench.plan``), as a share of the
device's busy time (moves ``forwards_per_s``)."""


def read(ctx):
    t = ctx.trace
    own = t.device_s(["iqbench.engine"], ["iqbench.forward", "iqbench.plan"])
    if own is None or t.busy_s <= 0:
        return None
    return 100.0 * own / t.busy_s
