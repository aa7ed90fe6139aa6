"""The dense layers' yield in the DGCNN attribution cells: the dense
products the window's forwards needed, over the operations of every product
the port's ``matmul`` ran (its work counter ``dense_products``, 2 x rows x
in x out a product, from the shapes), as a share (moves
``forwards_per_s``).

Needed (``dense_operations``): the terms of the reference module's
``flops`` other than the kNN inner products: each EdgeConv's two hoisted
products, x W1 and x (W2 - W1), and conv5 on each cloud's distinct points
(``work.distinct_points``: a collapsed point's rows repeat one row), the
head once a cloud.  So a cloud with no collapsed point needs all its rows,
and the yield reads 100% where the port computes nothing twice.
"""
from iqbench.port_counts import port_counter


def dense_operations(cfg, e) -> float:
    """Operations (2 a multiply-add) of the dense products of a work entry
    ``e`` (``clouds``, ``d``, ``forwards``)."""
    sd = e["d"].astype(float).sum()
    widths = cfg["edge_widths"]
    c_in = [cfg["input_channels"]] + widths[:-1]
    fwd = sum(2 * C * F * sd for C, F in zip(c_in, widths))
    fwd += sum(widths) * cfg["emb_dims"] * sd
    fc1, fc2 = cfg["fc_widths"]
    fwd += e["clouds"] * (2 * cfg["emb_dims"] * fc1 + fc1 * fc2
                          + fc2 * cfg["num_classes"])
    return 2.0 * e["forwards"] * fwd


def read(ctx):
    done = port_counter("dense_products")
    if not done or "edge_widths" not in ctx.cfg:
        return None
    return 100.0 * sum(dense_operations(ctx.cfg, e) for e in ctx.work()) / done
