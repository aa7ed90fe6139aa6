"""PCT, the Point Cloud Transformer classifier (Guo et al., arXiv:2012.09688),
in the layout of the public PyTorch release (class ``Pct`` of PCT_Pytorch's
``model.py``).  The JAX package has no counterpart: the port holds it to the
benchmark's plain reference (``iqbench/reference/pct.py``).

  * Embedding: Conv1d 3 -> 64 -> 64 without bias, each with BatchNorm and
    ReLU.
  * Two sample-and-group levels (512 centres of the 1024 points, then 256 of
    those 512): FPS centres, each centre's 32 nearest points in xyz, the
    neighbours' features as [f_j - f_c, f_c] through ``gather_local_i``
    (two 1x1 convs without bias, BatchNorm, ReLU), then the max over the 32.
  * ``pt_last``: two 1x1 convs 256 -> 256 without bias, BatchNorm, ReLU, then
    four offset-attention layers ``sa1``..``sa4``: Q and K one tied weight
    (256 -> 64, no bias), E = Q K^T without a 1/sqrt(d) scale, a softmax over
    each row, each column divided by 1e-9 plus its sum over the rows,
    x_r[j] = sum_i A[i, j] v_i with v = W_v x + b_v, and
    x + ReLU(BN(W_t (x - x_r) + b_t)).
  * ``conv_fuse``: the four attention outputs and the second level's
    features (1280) through Conv1d 1280 -> 1024 without bias, BatchNorm,
    LeakyReLU(0.2), then the max over the points.
  * The head: ``linear1`` 1024 -> 512 without bias, ``bn6``, LeakyReLU(0.2),
    dropout 0.5, ``linear2`` 512 -> 256, ``bn7``, LeakyReLU(0.2), dropout
    0.5, ``linear3`` 256 -> classes.

The fused eval path (``fused=True``, the default in eval) runs each level's
two convolutions through ``knn_group_max`` (kernel 10, ``ops/cuda/
knn_group.py``), with layer 1 hoisted above the gather as the edge convs
hoist it: [f_j - f_c, f_c] W1^T = f_j W1a^T + f_c (W1b - W1a)^T, so
u = f W1a^T on the N points and c = f_c (W1b - W1a)^T on the S centres,
BatchNorm 1 folded into both and BatchNorm 2 into layer 2.  ``conv_fuse``
and its max run through ``dense_pool`` (kernel 9, ``ops/cuda/dense.py``) on
two segments: the four attention outputs concatenated, and the second
level's features (kernel 9 also gives the mean, which PCT does not use).
The offset-attention layers are plain PyTorch in both paths, each inside
the profiler span ``iq_offset_attention``.  The plan (``models.plans.
pct_plan``) is each level's FPS and kNN indices (kernels 4 and 1 on the
card), which depend on distances alone.

``fused=False`` is the differentiable path: the grouped features gathered
by ``index_points``, every convolution a product, every BatchNorm in its
module's mode (``models.common.bn_apply``), the max over the slots and
over the points.  Training PCT (its optimiser and schedule) is not
ported.

Modules and parameter names are the release's, so its state dict loads
with ``strict=True``: ``q_conv.weight`` and ``k_conv.weight`` are one
tensor under two names, as the release ties them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from ..ops.cuda.dense import dense_pool
from ..ops.cuda.knn_group import knn_group_max
from ..ops.geometry import index_points
from ..ops.precision import matmul
from .common import (Dropout, bn_affine, bn_apply, conv_bn_relu,
                     leaky_relu02, pointwise)

LEVELS = ((512, 32), (256, 32))     # (centres, neighbours) of each level
EMBED = (64, 64)
LOCAL_WIDTHS = ((128, 128), (256, 256))
CHANNELS, QK, ATTENTION_LAYERS = 256, 64, 4
FUSE = 1024
COLUMN_EPS = 1e-9


def _weight(conv: nn.Module) -> torch.Tensor:
    """A 1x1 conv's weight as (out, in)."""
    return conv.weight.reshape(conv.weight.shape[0], -1)


def _conv_bn_leaky(x: torch.Tensor, conv: nn.Module, bn: nn.Module):
    """leaky_relu_0.2(bn(conv(x))), the BatchNorm in its module's mode."""
    return leaky_relu02(bn_apply(pointwise(x, conv), bn))


class LocalOp(nn.Module):
    """``gather_local_i``: two 1x1 convs without bias, each with BatchNorm
    and ReLU, on [f_j - f_c, f_c], then the max over the group."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv1d(c_in, c_out, kernel_size=1, bias=False)
        self.conv2 = nn.Conv1d(c_out, c_out, kernel_size=1, bias=False)
        self.bn1 = nn.BatchNorm1d(c_out)
        self.bn2 = nn.BatchNorm1d(c_out)

    def forward(self, f: torch.Tensor, fps_idx: torch.Tensor,
                idx: torch.Tensor, fused: bool) -> torch.Tensor:
        """f (B, N, C), the centres' indices (B, S), their neighbours'
        (B, S, K) -> (B, S, C')."""
        if not fused:
            fc = index_points(f, fps_idx)[:, :, None, :]        # (B, S, 1, C)
            fj = index_points(f, idx)                           # (B, S, K, C)
            e = torch.cat([fj - fc, fc.expand_as(fj)], dim=-1)
            h = conv_bn_relu(e, self.conv1, self.bn1)
            return conv_bn_relu(h, self.conv2, self.bn2).amax(dim=2)
        C = f.shape[-1]
        w1 = _weight(self.conv1)
        w1a, w1b = w1[:, :C], w1[:, C:]
        mul1, shift1 = bn_affine(self.bn1)
        mul2, shift2 = bn_affine(self.bn2)
        u = matmul(f, w1a.T * mul1).contiguous()                # (B, N, C1)
        c = matmul(index_points(f, fps_idx), (w1b - w1a).T * mul1) + shift1
        return knn_group_max(idx, u, c.contiguous(),
                             _weight(self.conv2).T * mul2, shift2)


class OffsetAttention(nn.Module):
    """``SA_Layer``: offset-attention over the points of one cloud."""

    def __init__(self, channels: int = CHANNELS, qk: int = QK):
        super().__init__()
        self.q_conv = nn.Conv1d(channels, qk, 1, bias=False)
        self.k_conv = nn.Conv1d(channels, qk, 1, bias=False)
        self.q_conv.weight = self.k_conv.weight     # tied, as released
        self.v_conv = nn.Conv1d(channels, channels, 1)
        self.trans_conv = nn.Conv1d(channels, channels, 1)
        self.after_norm = nn.BatchNorm1d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, N, C)."""
        with record_function("iq_offset_attention"):
            q = pointwise(x, self.q_conv)               # (B, N, qk), = k
            energy = matmul(q, q.transpose(1, 2))       # (B, N, N)
            att = torch.softmax(energy, dim=-1)
            att = att / (COLUMN_EPS + att.sum(dim=1, keepdim=True))
            v = pointwise(x, self.v_conv)
            x_r = matmul(att.transpose(1, 2), v)        # sum_i A[i, j] v_i
            return x + conv_bn_relu(x - x_r, self.trans_conv, self.after_norm)


class PointTransformerLast(nn.Module):
    def __init__(self, channels: int = CHANNELS):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, channels, kernel_size=1, bias=False)
        self.conv2 = nn.Conv1d(channels, channels, kernel_size=1, bias=False)
        self.bn1 = nn.BatchNorm1d(channels)
        self.bn2 = nn.BatchNorm1d(channels)
        for i in range(1, ATTENTION_LAYERS + 1):
            setattr(self, f"sa{i}", OffsetAttention(channels))

    def forward(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        """x (B, N, C) -> the outputs of sa1..sa4, (B, N, C) each."""
        x = conv_bn_relu(x, self.conv1, self.bn1)
        x = conv_bn_relu(x, self.conv2, self.bn2)
        outs = []
        for i in range(1, ATTENTION_LAYERS + 1):
            x = getattr(self, f"sa{i}")(x)
            outs.append(x)
        return outs


class PCTCls(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.levels = LEVELS            # (centres, neighbours) of each level
        self.conv1 = nn.Conv1d(3, EMBED[0], kernel_size=1, bias=False)
        self.conv2 = nn.Conv1d(EMBED[0], EMBED[1], kernel_size=1, bias=False)
        self.bn1 = nn.BatchNorm1d(EMBED[0])
        self.bn2 = nn.BatchNorm1d(EMBED[1])
        c_in = EMBED[1]
        for i, (c1, c2) in enumerate(LOCAL_WIDTHS):
            setattr(self, f"gather_local_{i}", LocalOp(2 * c_in, c1))
            c_in = c2
        self.pt_last = PointTransformerLast(CHANNELS)
        self.conv_fuse = nn.Sequential(
            nn.Conv1d(ATTENTION_LAYERS * CHANNELS + c_in, FUSE, kernel_size=1,
                      bias=False),
            nn.BatchNorm1d(FUSE), nn.LeakyReLU(negative_slope=0.2))
        self.linear1 = nn.Linear(FUSE, 512, bias=False)
        self.bn6 = nn.BatchNorm1d(512)
        self.dp1 = Dropout(0.5)
        self.linear2 = nn.Linear(512, 256)
        self.bn7 = nn.BatchNorm1d(256)
        self.dp2 = Dropout(0.5)
        self.linear3 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, plan=None, fused: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of clouds x (B, N, 3) -> (B, num_classes).  ``plan``: each
        level's (FPS indices, kNN indices) from ``models.plans.pct_plan``,
        else made here.  ``fused``: the levels through kernel 10 and the
        fuse layer through kernel 9 (True) or un-fused (False); None means
        fused in eval and un-fused in training, which cannot be fused.
        ``generator`` draws the dropout masks in training."""
        if fused is None:
            fused = not self.training
        if fused and self.training:
            raise ValueError("training cannot take the fused levels (they "
                             "fold eval BatchNorm); pass fused=False")
        if plan is None:
            from .plans import pct_plan
            plan = pct_plan(x, self.levels)
        f = conv_bn_relu(x, self.conv1, self.bn1)
        f = conv_bn_relu(f, self.conv2, self.bn2)
        for i, (fps_idx, idx) in enumerate(plan):
            f = getattr(self, f"gather_local_{i}")(f, fps_idx, idx, fused)
        outs = self.pt_last(f)
        conv, bn = self.conv_fuse[0], self.conv_fuse[1]
        if fused:       # the fuse layer and its max in one kernel
            h = dense_pool([torch.cat(outs, dim=-1), f], conv, bn)[:, :FUSE]
        else:
            h = torch.cat(outs + [f], dim=-1)
            h = _conv_bn_leaky(h, conv, bn).amax(dim=1)
        h = self.dp1(_conv_bn_leaky(h, self.linear1, self.bn6), generator)
        h = self.dp2(_conv_bn_leaky(h, self.linear2, self.bn7), generator)
        return pointwise(h, self.linear3)
