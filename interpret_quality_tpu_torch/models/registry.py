"""Model registry and forward-function wrapper (counterpart of
``interpret_quality_tpu/models/registry.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from .dgcnn import DGCNNCls, GCNNCls
from .pct import PCTCls
from .pointconv import PointConvDensityClsSsg
from .pointnet import PointNetCls
from .pointmlp import PointMLP
from .pointnet2 import PointNet2ClsMsg

MODEL_REGISTRY = {
    "pointnet": PointNetCls,
    "pointnet2": PointNet2ClsMsg,
    "pointconv": PointConvDensityClsSsg,
    "dgcnn": DGCNNCls,
    "gcnn": GCNNCls,
    "gcnn_adv": GCNNCls,
    "pct": PCTCls,
    "pointmlp": PointMLP,
}
EDGE_CONV = ("dgcnn", "gcnn", "gcnn_adv")


def build_model(name: str, num_classes: int = 10, k: int = 20):
    """Instantiate a model module by reference name, in eval mode; ``k``
    (the kNN size) is read by the edge-conv family only."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not in this package; it has "
            f"{sorted(MODEL_REGISTRY)}")
    kwargs = {"k": k} if name in EDGE_CONV else {}
    return MODEL_REGISTRY[name](num_classes=num_classes, **kwargs).eval()


def _logits(out):
    """The logits of a forward; PointNet returns (logits, trans_feat,
    crt_points) (reference tools/final_common.py:36-39)."""
    return out[0] if isinstance(out, tuple) else out


class ForwardFn:
    """Logits function ``(B, N, 3) -> (B, num_class)`` of a frozen eval
    model, plus the pose-invariant plan hooks the enumeration uses.  Each
    forward runs inside a profiler span ``iq_forward``, each plan inside
    ``iq_plan``."""

    def __init__(self, model: torch.nn.Module):
        self.model = model.eval()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("iq_forward"):
            return _logits(self.model(x))

    def plan_fn(self, x: torch.Tensor):
        """Pure-geometry plan of a coalition batch (models/plans.py), or
        None for a family without one (PointNet)."""
        from .plans import make_plan_fn
        with record_function("iq_plan"):
            builder = make_plan_fn(self.model)
            return None if builder is None else builder(x)

    def apply_plan_fn(self, x: torch.Tensor, plan) -> torch.Tensor:
        if plan is None:
            return self(x)
        with record_function("iq_forward"):
            return _logits(self.model(x, plan=plan))


def make_forward_fn(model: torch.nn.Module) -> ForwardFn:
    return ForwardFn(model)


def train_forward(model: torch.nn.Module, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """The forward a train step differentiates, in the model's own mode
    (un-fused in training): (logits (B, num_classes), trans_feat or None).
    PointNet's feature transform (B, 64, 64) feeds its regulariser; the
    other families have none."""
    out = model(x, generator=generator)
    if isinstance(out, tuple):
        return out[0], out[1]
    return out, None
