"""PointNet classifier with the 3x3 and 64x64 spatial transformers, eval mode
(counterpart of ``interpret_quality_tpu/models/pointnet.py``; reference
models/pointnet.py:11-115).

Three shared-MLP stages (the last without activation), a global max pool and
an FC head; the forward returns ``(logits, trans_feat, crt_points)`` as the
reference does, and ``ForwardFn`` keeps the logits.  PointNet builds no
graph, so it has no kernel and no plan.  Modules and parameter names are the
reference's (``feat.stn.conv1``, ``feat.fstn.bn4``, ``fc1``/``bn1``...);
the dropout before ``bn2`` holds no state and is identity in eval.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import bn_eval, conv_bn_relu, pointwise


class STNkd(nn.Module):
    """Spatial transformer predicting a (k, k) matrix, anchored at I."""

    def __init__(self, k: int = 64):
        super().__init__()
        self.k = k
        self.conv1 = nn.Conv1d(k, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.bn4 = nn.BatchNorm1d(512)
        self.bn5 = nn.BatchNorm1d(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, k) -> (B, k, k)."""
        h = conv_bn_relu(x, self.conv1, self.bn1)
        h = conv_bn_relu(h, self.conv2, self.bn2)
        h = conv_bn_relu(h, self.conv3, self.bn3).amax(dim=1)  # (B, 1024)
        h = conv_bn_relu(h, self.fc1, self.bn4)
        h = conv_bn_relu(h, self.fc2, self.bn5)
        h = pointwise(h, self.fc3) + torch.eye(
            self.k, dtype=h.dtype, device=h.device).reshape(-1)
        return h.reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    def __init__(self):
        super().__init__()
        self.stn = STNkd(3)
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.fstn = STNkd(64)

    def forward(self, x: torch.Tensor):
        """x (B, N, 3) -> (global feature (B, 1024), trans (B, 3, 3),
        trans_feat (B, 64, 64), crt_points (B, 1024): the point that
        attains each channel's max)."""
        trans = self.stn(x)
        x = conv_bn_relu(torch.matmul(x, trans), self.conv1, self.bn1)
        trans_feat = self.fstn(x)
        x = conv_bn_relu(torch.matmul(x, trans_feat), self.conv2, self.bn2)
        x = bn_eval(pointwise(x, self.conv3), self.bn3)        # no activation
        return x.amax(dim=1), trans, trans_feat, torch.argmax(x, dim=1)


class PointNetCls(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.feat = PointNetFeat()
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, num_classes)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)

    def forward(self, x: torch.Tensor):
        """Eval forward of clouds x (B, N, 3): (logits (B, num_classes),
        trans_feat, crt_points)."""
        if self.training:
            raise RuntimeError("the port's PointNet forward is eval-only; "
                               "call .eval() first")
        h, _, trans_feat, crt_points = self.feat(x)
        h = conv_bn_relu(h, self.fc1, self.bn1)
        h = conv_bn_relu(h, self.fc2, self.bn2)
        return pointwise(h, self.fc3), trans_feat, crt_points
