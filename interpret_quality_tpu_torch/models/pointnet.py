"""PointNet classifier with the 3x3 and 64x64 spatial transformers
(counterpart of ``interpret_quality_tpu/models/pointnet.py``; reference
models/pointnet.py:11-115).

Three shared-MLP stages (the last without activation), a global max pool and
an FC head; the forward returns ``(logits, trans_feat, crt_points)`` as the
reference does, and ``ForwardFn`` keeps the logits.  PointNet builds no
graph, so it has no kernel and no plan.  Modules and parameter names are the
reference's (``feat.stn.conv1``, ``feat.fstn.bn4``, ``fc1``/``bn1``...).
Every BatchNorm follows its module's mode (batch statistics in training);
the dropout (0.3) comes *before* ``bn2``, in the reference's order
relu(bn2(dropout(fc2(x)))), and holds no state.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.precision import matmul
from ..parallel import data_parallel
from .common import Dropout, bn_apply, conv_bn_relu, pointwise


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
        x = conv_bn_relu(matmul(x, trans), self.conv1, self.bn1)
        trans_feat = self.fstn(x)
        x = conv_bn_relu(matmul(x, trans_feat), self.conv2, self.bn2)
        x = bn_apply(pointwise(x, self.conv3), self.bn3)       # no activation
        return x.amax(dim=1), trans, trans_feat, torch.argmax(x, dim=1)


class PointNetCls(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.feat = PointNetFeat()
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, num_classes)
        self.dropout = Dropout(0.3)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Forward of clouds x (B, N, 3): (logits (B, num_classes),
        trans_feat, crt_points).  ``generator`` draws the dropout mask in
        training."""
        h, _, trans_feat, crt_points = self.feat(x)
        h = conv_bn_relu(h, self.fc1, self.bn1)
        h = self.dropout(pointwise(h, self.fc2), generator)
        h = torch.relu(bn_apply(h, self.bn2))
        return pointwise(h, self.fc3), trans_feat, crt_points


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """||T T^t - I||_F, the mean over the batch (reference
    pointnet.py:119-126).  Under a data-parallel context, this rank's share
    of the mean over the global batch (its sum over the global count): the
    shares of all ranks sum to it, as the losses' do."""
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    diff = torch.matmul(trans, trans.transpose(-1, -2)) - eye
    norms = torch.linalg.matrix_norm(diff)
    dp = data_parallel.active()
    if dp is None:
        return norms.mean()
    return norms.sum() / (norms.shape[0] * dp.world)
