"""PointNet++ (MSG) classifier (counterpart of
``interpret_quality_tpu/models/pointnet2.py``).

FPS with the first point fixed at index 0, sort-and-clamp ball query,
multi-scale set-abstraction levels whose branch input is [features, xyz
offsets], a group-all level on *uncentred* xyz ordered [xyz, features], and
an FC head (reference models/pointnet2.py:93-276).

Each MSG branch runs as one ``fused_ball_mlp3`` call: its ConvBN stack is
folded into affine maps, the feature rows of layer 1 are hoisted above the
gather (uf = features @ A1[:D]), and the kernel does the ball query, the
xyz-offset part of layer 1, layers 2-3 and the max.  FPS runs through
``ops.cuda.fps.fps``.  On CUDA both launch their kernels; on the CPU they run
their plain versions.

Training, and an eval forward that must be differentiated, take the
un-fused branch (``fused=False``, ``models/pointnet2.py:70-80`` of the JAX
package): FPS still through the FPS kernel (its indices carry no
gradient), the ball query (``query_ball_point``), the group [features, xyz
offsets], the ConvBN stack in its modules' mode and the max over the slots.

Modules and parameter names are the reference's (``sa1.conv_blocks.{b}.{j}``,
``sa1.bn_blocks.{b}.{j}``, ``sa3.mlp_convs.{j}``, ``fc1``/``bn1``...), so a
reference state dict loads with ``strict=True``; the dropouts ``drop1``/
``drop2`` (0.4) hold no state.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda.fps import fps
from ..ops.cuda.groups import fused_ball_mlp3
from ..ops.geometry import index_points, query_ball_point
from ..ops.precision import matmul
from .common import (Dropout, bn_apply, conv_bn_stack, fold_stack, mlp_stack,
                     pointwise)

# (npoint, radii, nsamples, branch widths) of the two MSG levels
SA1 = (512, (0.1, 0.2, 0.4), (16, 32, 128),
       ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = (128, (0.2, 0.4, 0.8), (32, 64, 128),
       ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
SA3 = (256, 512, 1024)


class SetAbstractionMsg(nn.Module):
    def __init__(self, npoint: int, radius_list, nsample_list, in_channel: int,
                 mlp_list):
        super().__init__()
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for mlp in mlp_list:
            convs, bns = conv_bn_stack(in_channel + 3, mlp)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                fps_idx: Optional[torch.Tensor] = None, fused: bool = True):
        """xyz (B, N, 3), points (B, N, D) or None; ``fps_idx`` (B, npoint)
        from ``models.plans.pointnet2_plan``, else FPS here.  Ball membership
        is always computed here: it depends on the absolute radius.
        ``fused``: each branch through ``fused_ball_mlp3`` (eval BatchNorm
        folded), else un-fused and differentiable.
        Returns new_xyz (B, npoint, 3) and the branches' maxima side by side
        (B, npoint, sum of last widths)."""
        if fps_idx is None:
            fps_idx = fps(xyz.detach().contiguous(), self.npoint)
        new_xyz = index_points(xyz, fps_idx)
        if not fused:
            return new_xyz, self._branches_unfused(xyz, points, new_xyz)
        xyz = xyz.contiguous()
        D = 0 if points is None else points.shape[-1]
        outs = []
        for convs, bns, radius, k in zip(self.conv_blocks, self.bn_blocks,
                                         self.radius_list, self.nsample_list):
            (a1, b1), (a2, b2), (a3, b3) = fold_stack(convs, bns)
            # input order [features, xyz offsets]: A1 rows [0:D] features
            uf = None if points is None else matmul(points, a1[:D])
            outs.append(fused_ball_mlp3(new_xyz, xyz, uf, b1, a1[D:], a2, b2,
                                        a3, b3, radius=radius, k=k))
        return new_xyz, torch.cat(outs, dim=-1)

    def _branches_unfused(self, xyz, points, new_xyz):
        """Each branch: ball query -> group [features, xyz offsets] ->
        ConvBN stack -> max over the slots."""
        outs = []
        for convs, bns, radius, k in zip(self.conv_blocks, self.bn_blocks,
                                         self.radius_list, self.nsample_list):
            group_idx = query_ball_point(radius, k, xyz, new_xyz)  # (B, S, K)
            grouped = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([index_points(points, group_idx),
                                     grouped], dim=-1)
            outs.append(mlp_stack(grouped, convs, bns).amax(dim=2))
        return torch.cat(outs, dim=-1)


class SetAbstractionAll(nn.Module):
    """Group-all level: the MLP on [xyz, features] of every point (xyz
    uncentred, reference pointnet2.py:119-136), max over the points."""

    def __init__(self, in_channel: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp_convs, self.mlp_bns = conv_bn_stack(in_channel, mlp)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        h = mlp_stack(torch.cat([xyz, points], dim=-1), self.mlp_convs,
                      self.mlp_bns)
        return h.amax(dim=1)                                   # (B, C_out)


class PointNet2ClsMsg(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.sa1 = SetAbstractionMsg(SA1[0], SA1[1], SA1[2], 0, SA1[3])
        c1 = sum(m[-1] for m in SA1[3])
        self.sa2 = SetAbstractionMsg(SA2[0], SA2[1], SA2[2], c1, SA2[3])
        c2 = sum(m[-1] for m in SA2[3])
        self.sa3 = SetAbstractionAll(c2 + 3, SA3)
        self.fc1 = nn.Linear(SA3[-1], 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.drop1 = Dropout(0.4)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)
        self.drop2 = Dropout(0.4)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, plan=None, fused: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of clouds x (B, N, 3) -> (B, num_classes).  ``plan``:
        (fps indices of SA1, of SA2) from ``models.plans.pointnet2_plan``.
        ``fused``: the MSG branches through ``fused_ball_mlp3`` (True) or
        un-fused (False); None means fused in eval and un-fused in training,
        which cannot be fused.  ``generator`` draws the dropout masks in
        training."""
        if fused is None:
            fused = not self.training
        if fused and self.training:
            raise ValueError("training cannot take the fused branches (they "
                             "fold eval BatchNorm); pass fused=False")
        f1, f2 = plan if plan is not None else (None, None)
        l1_xyz, l1_points = self.sa1(x, None, fps_idx=f1, fused=fused)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, fps_idx=f2,
                                     fused=fused)
        h = self.sa3(l2_xyz, l2_points)
        h = torch.relu(bn_apply(pointwise(h, self.fc1), self.bn1))
        h = self.drop1(h, generator)
        h = torch.relu(bn_apply(pointwise(h, self.fc2), self.bn2))
        h = self.drop2(h, generator)
        return pointwise(h, self.fc3)
