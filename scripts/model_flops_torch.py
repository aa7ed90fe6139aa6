"""Re-derive ``bench_torch.py``'s GFLOP_PER_FORWARD table on the PyTorch
port (counterpart of ``scripts/model_flops.py``).

Counts, with ``torch.utils.flop_counter.FlopCounterMode`` on the CPU, the
GFLOP of one single-cloud eval forward at N = 1024 of each family, from a
seeded port model (B = 2 clouds, the count divided by B):

  * ``unfused``: the forward with ``fused=False`` (PointNet has no fused
    path): the differentiable layers that training runs;
  * ``eval``: the eval default (fused), whose kernels take their plain
    PyTorch versions on the CPU.

The JAX count (XLA cost analysis of the JAX package's un-fused forward)
hoists the edge conv's matmul above the gather, so it measures the un-fused
forward for PointNet, PointNet++ and PointConv and the hoisted edge conv for
DGCNN and GCNN.  The ``counted`` column takes the same forms: ``unfused``
for the first three, ``eval`` for the edge-conv family, whose plain
``knn_gather_extrema`` and ``gather_extrema`` multiply the features once a
point before they gather (the hoisted form).  The port's un-fused edge conv
multiplies all k gathered edge features, k-fold the work; both columns are
printed so the gap stays visible.  ``FlopCounterMode`` counts matmuls and
convolutions only, where XLA also counts elementwise work.

    python scripts/model_flops_torch.py [--num_points 1024] [--json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from interpret_quality_tpu_torch.data.datasets import SyntheticClouds  # noqa: E402
from interpret_quality_tpu_torch.models import build_model  # noqa: E402

MODELS = ["pointnet", "pointnet2", "pointconv", "dgcnn", "gcnn"]
EDGE_CONV = ("dgcnn", "gcnn")
B = 2


def forward_gflop(name: str, fused: bool, num_points: int = 1024) -> float:
    """GFLOP per cloud of one eval forward of a seeded model on B
    synthetic clouds."""
    torch.manual_seed(0)
    model = build_model(name, num_classes=10)
    ds = SyntheticClouds(num_samples=B, num_points=num_points)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(B)]))
    kw = {} if name == "pointnet" else {"fused": fused}
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(x, **kw)
    return counter.get_total_flops() / B / 1e9


def count(num_points: int = 1024) -> dict:
    """Per family: unfused, eval and counted GFLOP per forward."""
    out = {}
    for name in MODELS:
        unfused = forward_gflop(name, False, num_points)
        fused = unfused if name == "pointnet" else forward_gflop(
            name, True, num_points)
        out[name] = {"unfused": unfused, "eval": fused,
                     "counted": fused if name in EDGE_CONV else unfused}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of the table")
    args = p.parse_args(argv)
    table = count(args.num_points)
    if args.json:
        print(json.dumps(table))
        return
    print(f"# GFLOP per forward at N={args.num_points} "
          "(FlopCounterMode, CPU): unfused | eval | counted")
    for name, row in table.items():
        print(f'    "{name}": {row["counted"]:.3f},   '
              f'# unfused {row["unfused"]:.3f}, eval {row["eval"]:.3f}')


if __name__ == "__main__":
    main()
