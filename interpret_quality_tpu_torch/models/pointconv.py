"""PointConv (density-weighted) SSG classifier (counterpart of
``interpret_quality_tpu/models/pointconv.py``).

  * Gaussian-KDE inverse point density, normalised per group by the group
    max (reference pointconv.py:376-377).
  * DensityNet 1->16->8->1 with ReLU after *every* layer: the reference's
    sigmoid branch is dead code (``if i == len(self.mlp_convs)`` inside a
    loop bounded by len-1, pointconv.py:226-234), kept so for parity.
  * WeightNet 3->8->8->16.
  * Set abstraction: the MLP on [xyz offsets, features], scaled by the
    density net, contracted against the WeightNet outputs over the
    neighbours, flattened C-major, then Linear + BN1d + ReLU.
  * The group-all level centres the cloud at its mean (pointconv.py:148-170).

The two SA levels run FPS (``ops.cuda.fps.fps``), then ``knn_with_density``
and ``fused_pointconv_sa`` (``ops.cuda.groups``), with layer 1 hoisted above
the gather (u = [xyz, features] @ A1 + b1, and the centre's share
csw = new_xyz @ A1[:3] subtracted per neighbour).  On CUDA they launch their
kernels; on the CPU they run their plain versions.  The group-all level is
plain PyTorch, as it is XLA in the JAX package.  ``knn_with_density``
selects at the process's kNN selection setting (``IQTPU_KNN_SELECT``) on
the card, as the JAX package's Pallas kernel does; the un-fused path's
``knn_point`` is exact at every setting, as XLA's top_k is there.

Training, and an eval forward that must be differentiated, take the
un-fused SA level (``fused=False``, ``models/pointconv.py:150-166`` of the
JAX package): FPS through the FPS kernel (its indices carry no gradient),
the KDE density, the k nearest points by ``knn_point`` (the kNN kernel takes
k <= 32 and SA2 needs 64), the grouped inverse density over its group max,
the MLP, the DensityNet scale, the WeightNet and the contraction
``einsum("bskc,bskw->bscw")`` flattened C-major, every BatchNorm in its
module's mode.

Modules and parameter names are the reference's (``sa1.mlp_convs.{j}``,
``sa1.weightnet.mlp_convs.{j}``, ``sa1.densitynet.mlp_bns.{j}``,
``sa1.linear``, ``sa1.bn_linear``...), so a reference state dict loads with
``strict=True``; the dropouts ``drop1``/``drop2`` (0.7) hold no state.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda.fps import fps
from ..ops.cuda.groups import fused_pointconv_sa, knn_with_density
from ..ops.geometry import compute_density, index_points, knn_point
from ..ops.precision import matmul
from .common import (Dropout, bn_apply, conv_bn_stack, fold_stack, mlp_stack,
                     pointwise)

WO = 16     # WeightNet output width


class DensityNet(nn.Module):
    def __init__(self, hidden: Sequence[int] = (16, 8)):
        super().__init__()
        self.mlp_convs, self.mlp_bns = conv_bn_stack(1, list(hidden) + [1])


class WeightNet(nn.Module):
    def __init__(self, in_channel: int = 3, out_channel: int = WO,
                 hidden: Sequence[int] = (8, 8)):
        super().__init__()
        self.mlp_convs, self.mlp_bns = conv_bn_stack(
            in_channel, list(hidden) + [out_channel])


class PointConvDensitySA(nn.Module):
    def __init__(self, npoint: Optional[int], nsample: Optional[int],
                 in_channel: int, mlp: Sequence[int], bandwidth: float,
                 group_all: bool):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.bandwidth, self.group_all = bandwidth, group_all
        self.mlp_convs, self.mlp_bns = conv_bn_stack(in_channel, mlp)
        self.weightnet = WeightNet(3, WO)
        self.linear = nn.Linear(WO * mlp[-1], mlp[-1])
        self.bn_linear = nn.BatchNorm1d(mlp[-1])
        self.densitynet = DensityNet()

    def _head(self, out: torch.Tensor) -> torch.Tensor:
        return torch.relu(bn_apply(pointwise(out, self.linear), self.bn_linear))

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                plan=None, fused: bool = True):
        """xyz (B, N, 3), points (B, N, D) or None.

        ``plan`` (``models.plans.pointconv_plan``): (fps_idx, idx, den, dmax)
        for an SA level, the inverse density (B, N) for the group-all level.
        ``fused``: an SA level through ``knn_with_density`` and
        ``fused_pointconv_sa`` (eval BatchNorm folded), else un-fused and
        differentiable; the group-all level is un-fused either way.
        Returns new_xyz (B, S, 3) and new_points (B, S, mlp[-1]); the
        group-all level returns (None, (B, mlp[-1])).
        """
        if self.group_all:
            return None, self._forward_all(xyz, points, plan)
        if not fused:
            return self._forward_unfused(xyz, points, plan)
        xyz = xyz.contiguous()
        if plan is not None:
            fps_idx, idx, den, dmax = plan
        else:
            inv_density = 1.0 / compute_density(xyz, self.bandwidth)
            fps_idx = fps(xyz, self.npoint)
        new_xyz = index_points(xyz, fps_idx)
        if plan is None:
            idx, den, dmax = knn_with_density(new_xyz, xyz, inv_density,
                                              self.nsample)
        (a1, b1), (a2, b2), (a3, b3) = fold_stack(self.mlp_convs, self.mlp_bns)
        # input order [xyz offsets, features] (reference pointconv.py:137)
        src = xyz if points is None else torch.cat([xyz, points], dim=-1)
        u = matmul(src, a1) + b1                                # (B, N, C1)
        csw = matmul(new_xyz, a1[:3])                           # (B, S, C1)
        dnet = fold_stack(self.densitynet.mlp_convs, self.densitynet.mlp_bns)
        wnet = fold_stack(self.weightnet.mlp_convs, self.weightnet.mlp_bns)
        out = fused_pointconv_sa(idx, den, dmax, new_xyz, u, xyz, csw,
                                 a2, b2, a3, b3, dnet, wnet, k=self.nsample)
        return new_xyz, self._head(out)

    def _forward_unfused(self, xyz, points, plan=None):
        if plan is not None:
            fps_idx, idx, den, _ = plan
            grouped_density = den[..., None]                    # (B, S, K, 1)
        else:
            inv_density = 1.0 / compute_density(xyz, self.bandwidth)
            fps_idx = fps(xyz.detach().contiguous(), self.npoint)
        new_xyz = index_points(xyz, fps_idx)                    # (B, S, 3)
        if plan is None:
            idx = knn_point(self.nsample, xyz, new_xyz)         # (B, S, K)
            grouped_density = index_points(inv_density[..., None], idx)
        grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None, :]
        # input order [xyz offsets, features] (reference pointconv.py:137)
        grouped = grouped_xyz if points is None else torch.cat(
            [grouped_xyz, index_points(points, idx)], dim=-1)
        h = mlp_stack(grouped, self.mlp_convs, self.mlp_bns)    # (B, S, K, C)
        inv_max = grouped_density.amax(dim=2, keepdim=True)
        h = h * mlp_stack(grouped_density / inv_max, self.densitynet.mlp_convs,
                          self.densitynet.mlp_bns)
        weights = mlp_stack(grouped_xyz, self.weightnet.mlp_convs,
                            self.weightnet.mlp_bns)             # (B, S, K, 16)
        out = torch.einsum("bskc,bskw->bscw", h, weights)       # C-major
        return new_xyz, self._head(out.reshape(*out.shape[:2], -1))

    def _forward_all(self, xyz, points, inv_density=None):
        if inv_density is None:
            inv_density = 1.0 / compute_density(xyz, self.bandwidth)
        grouped_xyz = xyz - xyz.mean(dim=1, keepdim=True)       # centred
        grouped = grouped_xyz if points is None else torch.cat(
            [grouped_xyz, points], dim=-1)
        h = mlp_stack(grouped, self.mlp_convs, self.mlp_bns)    # (B, N, C)
        gd = inv_density[..., None]                             # (B, N, 1)
        scale = mlp_stack(gd / gd.amax(dim=1, keepdim=True),
                          self.densitynet.mlp_convs, self.densitynet.mlp_bns)
        weights = mlp_stack(grouped_xyz, self.weightnet.mlp_convs,
                            self.weightnet.mlp_bns)             # (B, N, 16)
        out = torch.einsum("bnc,bnw->bcw", h * scale, weights)
        return self._head(out.reshape(out.shape[0], -1))        # (B, C)


class PointConvDensityClsSsg(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.sa1 = PointConvDensitySA(512, 32, 3, (64, 64, 128), 0.1, False)
        self.sa2 = PointConvDensitySA(128, 64, 128 + 3, (128, 128, 256), 0.2,
                                      False)
        self.sa3 = PointConvDensitySA(1, None, 256 + 3, (256, 512, 1024), 0.4,
                                      True)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.drop1 = Dropout(0.7)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)
        self.drop2 = Dropout(0.7)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, plan=None, fused: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of clouds x (B, N, 3) -> (B, num_classes).  ``plan``:
        ((SA1 plan, SA2 plan), group-all inverse density) from
        ``models.plans.pointconv_plan``.  ``fused``: the SA levels through
        their kernels (True) or un-fused (False); None means fused in eval
        and un-fused in training, which cannot be fused.  ``generator``
        draws the dropout masks in training."""
        if fused is None:
            fused = not self.training
        if fused and self.training:
            raise ValueError("training cannot take the fused SA levels (they "
                             "fold eval BatchNorm); pass fused=False")
        levels, invden3 = plan if plan is not None else ((None, None), None)
        l1_xyz, l1_points = self.sa1(x, None, plan=levels[0], fused=fused)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, plan=levels[1],
                                     fused=fused)
        _, h = self.sa3(l2_xyz, l2_points, plan=invden3)
        h = torch.relu(bn_apply(pointwise(h, self.fc1), self.bn1))
        h = self.drop1(h, generator)
        h = torch.relu(bn_apply(pointwise(h, self.fc2), self.bn2))
        h = self.drop2(h, generator)
        return pointwise(h, self.fc3)
