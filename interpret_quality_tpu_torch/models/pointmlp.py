"""PointMLP, the residual MLP classifier of point clouds (Ma, Qin, You, Ran
and Fu, arXiv:2202.07123), the full model ``pointMLP()`` of the public
release (pointMLP-pytorch's ``classification_ModelNet40/models/
pointmlp.py``: embed 64, four stages, 24 neighbours, ``normalize="anchor"``,
no xyz in the groups, no conv bias, ReLU).  The JAX package has no
counterpart: the port holds it to the benchmark's plain reference
(``iqbench/reference/pointmlp.py``).

  * ``embedding``: Conv1d 3 -> 64 without bias, BatchNorm, ReLU.
  * Four stages, stage i keeping points // 2^(i+1) anchors (512, 256, 128
    and 64 of 1024) and doubling the width (128, 256, 512, 1024):
    FPS centres; each centre's 24 nearest of the stage's points in xyz;
    the geometric affine of ``local_grouper_list.i``, d_sj = f_j - f_s,
    sigma_b = ``torch.std`` (unbiased) over all of cloud b's d, g =
    alpha * d / (sigma_b + 1e-5) + beta; [g, f_s] through
    ``pre_blocks_list.i``: ``transfer`` (Conv1d 2 C_in -> C, BatchNorm,
    ReLU), two residual blocks y = relu(BN(W2 relu(BN(W1 x))) + x), the max
    over the 24 slots; then ``pos_blocks_list.i``, two residual blocks on
    the centres.
  * The max over the last 64 points, then ``classifier``: Linear 1024 ->
    512, BatchNorm, ReLU, dropout 0.5, Linear 512 -> 256, BatchNorm, ReLU,
    dropout 0.5, Linear 256 -> classes.

The fused eval path (``fused=True``, the default in eval) hoists each
stage's transfer above the gather: with W_t = [W_a | W_b] and its BatchNorm
folded to (m, t), u = f (W_a diag alpha)^T m on the stage's N points,
c_s = m (W_b f_s + W_a beta) + t on the S centres, and
h0_sj = relu((u_idx[s,j] - u_fps[s]) / (sigma_b + 1e-5) + c_s), which is
the transfer up to rounding.  sigma_b is plain PyTorch over chunks of
clouds (at most about 1 GB live), inside the profiler span
``iq_group_std``.  h0, the two residual blocks and the max run in
``group_res_mlp`` (kernel 11, ``ops/cuda/group_mlp.py``); the pos-blocks,
the embedding and the classifier through ``ops.precision.matmul`` with
their BatchNorms folded.  The hoist is kept, with the centre's row u_fps[s]
taken off inside the kernel before the scale: folded into c_s as
-u_fps[s] / (sigma_b + 1e-5), it left c_s nothing but rounding where
sigma_b is 0 (the empty coalition collapses a cloud to one point, so every
difference is 0 and the scale is 1e5: its logits moved by 8e-4 of their
RMS on the CPU).  Taken after the product, u_j - u_s is exact where the
points are one point and otherwise carries the rounding of two f32 rows.
The plan (``models.plans.pointmlp_plan``) is each stage's FPS and kNN
indices (kernels 4 and 1 on the card), which depend on distances alone;
sigma_b depends on the features, so it stays in the forward.

``fused=False`` is the differentiable path: the groups gathered by
``index_points``, every layer a product, every BatchNorm in its module's
mode (``models.common.bn_apply``).  Training PointMLP (its optimiser and
schedule) is not ported.

Modules and parameter names are the release's, so its state dict loads
with ``strict=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from ..ops.cuda.group_mlp import group_res_mlp
from ..ops.geometry import index_points
from ..ops.precision import matmul
from .common import Dropout, bn_affine, bn_apply, conv_bn_relu, pointwise

POINTS = 1024               # the release's ``points``: stage i keeps points // 2^(i+1)
EMBED = 64
STAGES = 4
NEIGHBOURS = 24
BLOCKS = 2                  # residual blocks before and after each stage's max
FC = (512, 256)
STD_EPS = 1e-5
STD_CHUNK_BYTES = 1 << 29   # one gathered chunk of differences for sigma


def _weight(conv: nn.Module) -> torch.Tensor:
    """A 1x1 conv's or Linear's weight as (out, in)."""
    return conv.weight.reshape(conv.weight.shape[0], -1)


def _folded(layer: nn.Module, bn: nn.Module):
    """``layer`` (no bias) with its eval BatchNorm folded: (a (in, out),
    b (out,)) with bn(x W^T) = x a + b."""
    mul, shift = bn_affine(bn)
    return _weight(layer).T * mul, shift


class ConvBNReLU1D(nn.Module):
    """Conv1d without bias, BatchNorm, ReLU (``net.0``, ``net.1``)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(c_in, c_out, 1, bias=False),
                                 nn.BatchNorm1d(c_out), nn.ReLU())

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if fused:
            a, b = _folded(self.net[0], self.net[1])
            return torch.relu(matmul(x, a) + b)
        return conv_bn_relu(x, self.net[0], self.net[1])


class ConvBNReLURes1D(nn.Module):
    """y = relu(BN(W2 relu(BN(W1 x))) + x) (``net1.{0,1}``,
    ``net2.{0,1}``), over the last axis of a channels-last x."""

    def __init__(self, c: int):
        super().__init__()
        self.net1 = nn.Sequential(nn.Conv1d(c, c, 1, bias=False),
                                  nn.BatchNorm1d(c), nn.ReLU())
        self.net2 = nn.Sequential(nn.Conv1d(c, c, 1, bias=False),
                                  nn.BatchNorm1d(c))

    def folded(self):
        """(a1, b1, a2, b2): both layers with their BatchNorms folded."""
        return (*_folded(self.net1[0], self.net1[1]),
                *_folded(self.net2[0], self.net2[1]))

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if fused:
            a1, b1, a2, b2 = self.folded()
            h = torch.relu(matmul(x, a1) + b1)
            return torch.relu(matmul(h, a2) + b2 + x)
        h = conv_bn_relu(x, self.net1[0], self.net1[1])
        return torch.relu(bn_apply(pointwise(h, self.net2[0]), self.net2[1]) + x)


class LocalGrouper(nn.Module):
    """The geometric affine's parameters, (1, 1, 1, C_in) each; the
    grouping itself is ``PointMLP._stage``."""

    def __init__(self, channel: int):
        super().__init__()
        self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, channel))
        self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, channel))


class PreExtraction(nn.Module):
    def __init__(self, c_in: int, c_out: int, blocks: int = BLOCKS):
        super().__init__()
        self.transfer = ConvBNReLU1D(2 * c_in, c_out)
        self.operation = nn.Sequential(*[ConvBNReLURes1D(c_out)
                                         for _ in range(blocks)])


class PosExtraction(nn.Module):
    def __init__(self, c: int, blocks: int = BLOCKS):
        super().__init__()
        self.operation = nn.Sequential(*[ConvBNReLURes1D(c)
                                         for _ in range(blocks)])


def group_differences(f: torch.Tensor, fps_idx: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """d_sj = f_idx[s,j] - f_fps[s]: (B, N, C) -> (B, S, K, C)."""
    return index_points(f, idx) - index_points(f, fps_idx)[:, :, None, :]


def group_std(f: torch.Tensor, fps_idx: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """sigma_b, ``torch.std`` (unbiased) over each cloud's S K C
    differences, as the release computes it: (B,).  In chunks of clouds,
    so that about ``STD_CHUNK_BYTES`` of differences are live at once."""
    B, S, K = idx.shape
    chunk = max(1, STD_CHUNK_BYTES // (4 * S * K * f.shape[-1]))
    return torch.cat([
        torch.std(group_differences(f[s:s + chunk], fps_idx[s:s + chunk],
                                    idx[s:s + chunk]).reshape(
                      min(chunk, B - s), -1), dim=1)
        for s in range(0, B, chunk)])


class PointMLP(nn.Module):
    def __init__(self, num_classes: int = 10, points: Optional[int] = None):
        super().__init__()
        self.points = POINTS if points is None else points
        self.embedding = ConvBNReLU1D(3, EMBED)
        self.local_grouper_list = nn.ModuleList()
        self.pre_blocks_list = nn.ModuleList()
        self.pos_blocks_list = nn.ModuleList()
        levels, anchors, c = [], self.points, EMBED
        for _ in range(STAGES):
            anchors //= 2
            self.local_grouper_list.append(LocalGrouper(c))
            self.pre_blocks_list.append(PreExtraction(c, 2 * c))
            self.pos_blocks_list.append(PosExtraction(2 * c))
            levels.append((anchors, NEIGHBOURS))
            c *= 2
        self.levels = tuple(levels)     # (anchors, neighbours) of each stage
        self.classifier = nn.Sequential(
            nn.Linear(c, FC[0]), nn.BatchNorm1d(FC[0]), nn.ReLU(),
            Dropout(0.5),
            nn.Linear(FC[0], FC[1]), nn.BatchNorm1d(FC[1]), nn.ReLU(),
            Dropout(0.5),
            nn.Linear(FC[1], num_classes))

    def _stage(self, i: int, f: torch.Tensor, fps_idx: torch.Tensor,
               idx: torch.Tensor, fused: bool) -> torch.Tensor:
        """Stage i on the features f (B, N, C_in) -> (B, S, C)."""
        grouper = self.local_grouper_list[i]
        pre, pos = self.pre_blocks_list[i], self.pos_blocks_list[i]
        if not fused:
            alpha = grouper.affine_alpha.reshape(-1)
            beta = grouper.affine_beta.reshape(-1)
            fs = index_points(f, fps_idx)                       # (B, S, C_in)
            d = group_differences(f, fps_idx, idx)              # (B, S, K, C_in)
            sig = torch.std(d.reshape(d.shape[0], -1), dim=1)
            g = alpha * d / (sig + STD_EPS)[:, None, None, None] + beta
            h = pre.transfer(torch.cat([g, fs[:, :, None, :].expand_as(g)],
                                       dim=-1))
            for block in pre.operation:
                h = block(h)
            f = h.amax(dim=2)
        else:
            f = group_res_mlp(idx, fps_idx, *self.group_inputs(i, f, fps_idx, idx))
        for block in pos.operation:
            f = block(f, fused)
        return f

    def group_inputs(self, i: int, f: torch.Tensor, fps_idx: torch.Tensor,
                     idx: torch.Tensor):
        """Kernel 11's inputs at stage i beside the indices, from the
        features f (B, N, C_in): u (B, N, C), c (B, S, C), sig (B,) and the
        two residual blocks folded, (a1, b1, a2, b2) each."""
        grouper, pre = self.local_grouper_list[i], self.pre_blocks_list[i]
        alpha = grouper.affine_alpha.reshape(-1)
        beta = grouper.affine_beta.reshape(-1)
        with record_function("iq_group_std"):
            sig = 1.0 / (group_std(f, fps_idx, idx) + STD_EPS)
        C = f.shape[-1]
        w = _weight(pre.transfer.net[0])
        wa, wb = w[:, :C], w[:, C:]
        mul, shift = bn_affine(pre.transfer.net[1])
        u = matmul(f, (wa * alpha).T * mul).contiguous()
        c = (matmul(index_points(f, fps_idx), wb.T) + wa @ beta) * mul + shift
        return u, c.contiguous(), sig, [block.folded() for block in pre.operation]

    def forward(self, x: torch.Tensor, plan=None, fused: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of clouds x (B, N, 3) -> (B, num_classes).  ``plan``: each
        stage's (FPS indices, kNN indices) from ``models.plans.
        pointmlp_plan``, else made here.  ``fused``: the stages' groups
        through kernel 11 and the other layers with their BatchNorms folded
        (True) or un-fused (False); None means fused in eval and un-fused in
        training, which cannot be fused.  ``generator`` draws the dropout
        masks in training."""
        if fused is None:
            fused = not self.training
        if fused and self.training:
            raise ValueError("training cannot take the fused stages (they "
                             "fold eval BatchNorm); pass fused=False")
        if plan is None:
            from .plans import pointmlp_plan
            plan = pointmlp_plan(x, self.levels)
        f = self.embedding(x, fused)
        for i, (fps_idx, idx) in enumerate(plan):
            f = self._stage(i, f, fps_idx, idx, fused)
        h = f.amax(dim=1)
        cl = self.classifier
        for lin, bn, drop in ((cl[0], cl[1], cl[3]), (cl[4], cl[5], cl[7])):
            if fused:
                mul, shift = bn_affine(bn)
                h = torch.relu(matmul(h, _weight(lin).T * mul)
                               + lin.bias * mul + shift)
            else:
                h = torch.relu(bn_apply(pointwise(h, lin), bn))
            h = drop(h, generator)
        return pointwise(h, cl[8])
