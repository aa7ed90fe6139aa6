"""DGCNN and GCNN classifiers (counterpart of
``interpret_quality_tpu/models/dgcnn.py``).

DGCNN recomputes the kNN graph in feature space before every edge conv
(reference models/dgcnn.py:51-120); GCNN reuses the input-space graph for
all four layers (dgcnn.py:123-194).

Modules and parameter names are the reference's, so a reference state dict
loads with ``strict=True``: ``conv{i}`` is ``Sequential(Conv2d(2C, F, 1,
bias=False), bn{i}, LeakyReLU)`` with ``bn{i}`` the same module object
registered as ``self.bn{i}`` and as ``conv{i}.1``; ``conv5`` is a Conv1d;
``linear1`` has no bias.

The eval edge conv hoists the 1x1 conv above the neighbour gather:

    [x_j - x_i, x_i] @ [W1; W2] = x_j @ W1 + x_i @ (W2 - W1)

so a = x @ W1 and b = x @ (W2 - W1) are computed once per layer, and

    max_j act(bn(edge))[i] = act(alpha * (b[i] + ext_j a[idx[i, j]]) + beta)

with ext = max where the BN scale alpha > 0 and min otherwise (BN is a
per-channel affine map in eval, LeakyReLU is monotone).  The extrema come
from the neighbour kernels: ``knn_gather_extrema`` (graph from features) or
``gather_extrema`` (given indices).  The eval head, conv5 with its
BatchNorm and LeakyReLU and the max and mean over the points, is one
kernel, ``dense_pool`` (``ops/cuda/dense.py``), which reads the four edge
outputs where they lie: the (B, N, 1024) activation never exists.  DGCNN
hands it the copy lists of its first kernel-3 launch, so on the card it
multiplies each cloud's distinct rows only (a masked coalition's collapsed
regions repeat one row).

Training, and an eval forward that must be differentiated, take the
un-fused edge conv and head (``fused=False``): the edge features
[x_j - x_i, x_i] gathered by ``index_points``, the 1x1 conv as one matmul,
BatchNorm over (B, N, k) (in training on the batch statistics, with the
n/(n-1) running variance of the JAX package's edge convs), LeakyReLU and
the max over k (``models/dgcnn.py:100-113`` there).  Its graphs still come from the kNN
kernel (``knn``): an index selection carries no gradient.  ``dp1``/``dp2``
are the reference's dropouts, with no state.

The kNN selection setting (``IQTPU_KNN_SELECT``, ``IQTPU_KNN_LAYOUT``)
reaches the fused eval path only (kernel 3, GCNN's graph, the plan), as in
the JAX package; the un-fused path's graphs (``graph_knn``) are exact.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda.dense import dense_pool
from ..ops.cuda.neighbors import gather_extrema, knn, knn_gather_extrema
from ..ops.geometry import index_points
from ..ops.precision import matmul
from .common import Dropout, bn_affine, bn_apply, leaky_relu02, pointwise

EDGE_WIDTHS = (64, 64, 128, 256)
EMB_DIMS = 1024


def edge_conv(x: torch.Tensor, block: nn.Sequential, k: int,
              idx: Optional[torch.Tensor] = None,
              copy_lists: bool = False):
    """Eval edge convolution on channels-last x (B, N, C) -> (B, N, F).

    ``idx`` (B, N, k): use these neighbours; None: select the k nearest
    neighbours of x in feature space inside the fused kernel.
    ``copy_lists`` (with ``idx`` None): return (out, lists), the kernel's
    distinct rows of x and their copies (``neighbors.DistinctRows``; None
    on the CPU).  A row equal to an earlier one in x is equal to it in out.
    """
    conv, bn = block[0], block[1]
    C = x.shape[-1]
    w = conv.weight.reshape(conv.weight.shape[0], 2 * C)        # (F, 2C)
    w1, w2 = w[:, :C], w[:, C:]
    a = matmul(x, w1.T).contiguous()                           # (B, N, F)
    b = matmul(x, (w2 - w1).T)
    if idx is None:
        amax, amin, lists = knn_gather_extrema(x.contiguous(), a, k,
                                               copy_lists=True)
    else:
        (amax, amin), lists = gather_extrema(idx, a), None
    alpha, beta = bn_affine(bn)
    m_ext = b + torch.where(alpha > 0, amax, amin)
    out = leaky_relu02(alpha * m_ext + beta)
    return (out, lists) if copy_lists else out


def graph_knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest neighbours of each row of x (B, N, C) within its cloud
    (self included), through the kNN kernel; the selection is not
    differentiated, so the kernel reads a detached copy.  Exact at every
    kNN selection setting: the JAX package's un-fused path (training, the
    BIM attack) selects with XLA's top_k."""
    xs = x.detach().contiguous()
    return knn(xs, xs, k, select="two_pass")


def edge_conv_unfused(x: torch.Tensor, block: nn.Sequential,
                      idx: torch.Tensor) -> torch.Tensor:
    """The edge convolution as the reference computes it, differentiable:
    x (B, N, C), neighbours idx (B, N, k) -> (B, N, F)."""
    conv, bn = block[0], block[1]
    neigh = index_points(x, idx)                                # (B, N, k, C)
    centre = x[:, :, None, :].expand_as(neigh)
    e = torch.cat([neigh - centre, centre], dim=-1)             # (B, N, k, 2C)
    y = pointwise(e, conv)                                      # (B, N, k, F)
    return leaky_relu02(bn_apply(y, bn, unbiased_update=True)).amax(dim=2)


class _DGCNNBase(nn.Module):
    dynamic_graph = True

    def __init__(self, num_classes: int = 10, k: int = 20):
        super().__init__()
        self.k = k
        self.bn1 = nn.BatchNorm2d(64)
        self.bn2 = nn.BatchNorm2d(64)
        self.bn3 = nn.BatchNorm2d(128)
        self.bn4 = nn.BatchNorm2d(256)
        self.bn5 = nn.BatchNorm1d(EMB_DIMS)
        c_in = 3
        for i, (f, bn) in enumerate(zip(EDGE_WIDTHS, (self.bn1, self.bn2,
                                                      self.bn3, self.bn4))):
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(2 * c_in, f, kernel_size=1, bias=False), bn,
                nn.LeakyReLU(negative_slope=0.2)))
            c_in = f
        self.conv5 = nn.Sequential(
            nn.Conv1d(sum(EDGE_WIDTHS), EMB_DIMS, kernel_size=1, bias=False),
            self.bn5, nn.LeakyReLU(negative_slope=0.2))
        self.linear1 = nn.Linear(EMB_DIMS * 2, 512, bias=False)
        self.bn6 = nn.BatchNorm1d(512)
        self.dp1 = Dropout(0.5)
        self.linear2 = nn.Linear(512, 256)
        self.bn7 = nn.BatchNorm1d(256)
        self.dp2 = Dropout(0.5)
        self.linear3 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, plan: Optional[torch.Tensor] = None,
                fused: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of clouds x (B, N, 3) -> (B, num_classes).

        ``plan``: precomputed input-space kNN indices (B, N, k) from
        ``models.plans.dgcnn_plan`` — the layer-1 graph for DGCNN, the
        shared fixed graph for GCNN.  It is pose-invariant, so the
        enumeration builds it once per order chunk.
        ``fused``: the eval edge conv through the fused kernels (True) or
        the un-fused, differentiable one (False); None means fused in eval
        and un-fused in training, which cannot be fused.
        ``generator``: draws the dropout masks in training.
        """
        if fused is None:
            fused = not self.training
        if fused and self.training:
            raise ValueError("training cannot take the fused edge conv "
                             "(it folds eval BatchNorm); pass fused=False")
        convs = (self.conv1, self.conv2, self.conv3, self.conv4)
        x = x.contiguous()
        feats, lists = [], None
        if not fused:
            fix_idx = plan if plan is not None else graph_knn(x, self.k)
            h = x
            for i, block in enumerate(convs):
                idx = graph_knn(h, self.k) if (
                    self.dynamic_graph and i > 0) else fix_idx
                h = edge_conv_unfused(h, block, idx)
                feats.append(h)
        elif self.dynamic_graph:
            # The head walks the distinct rows of the first kernel-3 launch
            # (layer 2 with a plan, layer 1 without): its copies take their
            # original's result, so rows equal in its input stay equal in
            # every later edge output.  A later launch's classes may merge
            # rows that differ in an earlier output, so only the first
            # launch's lists hold for all four.
            h, first = x, 0 if plan is None else 1
            for i, block in enumerate(convs):
                if i < first:
                    h = edge_conv(h, block, self.k, idx=plan)
                elif i == first:
                    h, lists = edge_conv(h, block, self.k, copy_lists=True)
                else:
                    h = edge_conv(h, block, self.k)
                feats.append(h)
        else:
            fix_idx = plan if plan is not None else knn(x, x, self.k)
            h = x
            for block in convs:
                h = edge_conv(h, block, self.k, idx=fix_idx)
                feats.append(h)

        if fused:       # conv5, BN, LeakyReLU and both poolings in one kernel
            # the lists only where there are any: not on the CPU, not GCNN
            h = dense_pool(feats, self.conv5[0], self.bn5,
                           *([] if lists is None else [lists]))  # (B, 2048)
        else:
            h = torch.cat(feats, dim=-1)                        # (B, N, 512)
            h = leaky_relu02(bn_apply(pointwise(h, self.conv5[0]), self.bn5))
            h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        h = leaky_relu02(bn_apply(pointwise(h, self.linear1), self.bn6))
        h = self.dp1(h, generator)
        h = leaky_relu02(bn_apply(pointwise(h, self.linear2), self.bn7))
        h = self.dp2(h, generator)
        return pointwise(h, self.linear3)


class DGCNNCls(_DGCNNBase):
    dynamic_graph = True


class GCNNCls(_DGCNNBase):
    dynamic_graph = False
