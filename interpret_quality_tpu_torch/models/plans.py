"""Pose-invariant graph plans (counterpart of
``interpret_quality_tpu/models/plans.py``).

Every enumeration pose is a rigid or uniform-scale transform of the same
masked coalition batch, and masking commutes with the transform.  FPS, kNN
graphs and KDE densities depend only on pairwise distances, so the
enumeration builds them once per order chunk from the undisturbed batch and
reuses them for every pose.  Deviation from per-pose recomputation is
confined to distance ties at floating-point noise.

What each family's plan carries, and the enum modes that may reuse it:

  * dgcnn, gcnn, gcnn_adv: the input-space kNN graph; trans/rotate/scale.
  * pointnet2: the FPS indices of both SA levels.  Ball membership depends
    on the absolute radius, so the kernel recomputes it per pose on the
    transformed coordinates; trans/rotate/scale.
  * pointconv: per SA level the FPS indices, kNN indices, gathered inverse
    densities and their per-group max, plus the group-all level's inverse
    density.  Density values change under scale: trans/rotate only.
  * pct: the FPS indices and the kNN indices (in xyz) of both
    sample-and-group levels; trans/rotate/scale.
  * pointmlp: the same of its four stages; its per-cloud std is of the
    features, so it stays in the forward; trans/rotate/scale.
  * pointnet: no plan (no graph; its transformers are pose-dependent).

On the card the plans' kNN selections (``knn``, ``knn_with_density``)
follow the process's kNN selection setting (``IQTPU_KNN_SELECT``), as the
JAX package's Pallas plans do; on the CPU they are exact, as its XLA plans
are.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.cuda.fps import fps
from ..ops.cuda.groups import knn_with_density
from ..ops.cuda.neighbors import knn
from ..ops.geometry import compute_density, index_points

# enum modes whose transform keeps each family's plan (up to fp-noise ties)
PLAN_MODES = {
    "dgcnn": frozenset({"trans", "rotate", "scale"}),
    "gcnn": frozenset({"trans", "rotate", "scale"}),
    "gcnn_adv": frozenset({"trans", "rotate", "scale"}),
    "pointnet2": frozenset({"trans", "rotate", "scale"}),
    "pointconv": frozenset({"trans", "rotate"}),
    "pct": frozenset({"trans", "rotate", "scale"}),
    "pointmlp": frozenset({"trans", "rotate", "scale"}),
}


def dgcnn_plan(x: torch.Tensor, k: int) -> torch.Tensor:
    """Input-space kNN graph: (B, N, 3) -> (B, N, k) int32."""
    return knn(x.contiguous(), x.contiguous(), k)


def pointnet2_plan(x: torch.Tensor, npoints):
    """FPS indices of each SA level, (B, npoint) int32 each; ``npoints`` is
    (512, 128) for PointNet++."""
    plan, xyz = [], x.contiguous()
    for npoint in npoints:
        plan.append(fps(xyz, npoint))
        xyz = index_points(xyz, plan[-1])
    return tuple(plan)


def pointconv_plan(x: torch.Tensor, levels_spec, bandwidth_all: float):
    """Per SA level (fps_idx, knn idx, gathered inverse densities, group
    max), plus the group-all level's inverse density (B, S_last).
    ``levels_spec``: (npoint, nsample, bandwidth) per SA level."""
    levels = []
    xyz = x.contiguous()
    for npoint, nsample, bandwidth in levels_spec:
        inv_density = 1.0 / compute_density(xyz, bandwidth)     # (B, N)
        fps_idx = fps(xyz, npoint)
        new_xyz = index_points(xyz, fps_idx)
        idx, den, dmax = knn_with_density(new_xyz, xyz, inv_density, nsample)
        levels.append((fps_idx, idx, den, dmax))
        xyz = new_xyz
    return (tuple(levels), 1.0 / compute_density(xyz, bandwidth_all))


def pct_plan(x: torch.Tensor, levels):
    """Per level (FPS indices (B, S) int32, kNN indices (B, S, K) int32):
    each level's centres by FPS and their K nearest points of the level's
    cloud in xyz.  ``levels``: (centres, neighbours) per level, (512, 32)
    and (256, 32) for PCT."""
    plan, xyz = [], x.contiguous()
    for npoint, nsample in levels:
        fps_idx = fps(xyz, npoint)
        new_xyz = index_points(xyz, fps_idx)
        plan.append((fps_idx, knn(new_xyz, xyz, nsample)))
        xyz = new_xyz
    return tuple(plan)


def pointmlp_plan(x: torch.Tensor, levels):
    """Per stage (FPS indices (B, S) int32, kNN indices (B, S, K) int32),
    as ``pct_plan`` makes them; ``levels``: (anchors, neighbours) per stage,
    (512, 24), (256, 24), (128, 24) and (64, 24) for PointMLP at 1024
    points."""
    return pct_plan(x, levels)


def make_plan_fn(model) -> Optional[Callable]:
    """Plan function ``(B, N, 3) -> plan`` for a model instance; None for a
    family without a plan (PointNet)."""
    from .dgcnn import _DGCNNBase
    from .pct import PCTCls
    from .pointconv import PointConvDensityClsSsg
    from .pointmlp import PointMLP
    from .pointnet import PointNetCls
    from .pointnet2 import PointNet2ClsMsg
    if isinstance(model, _DGCNNBase):
        k = model.k
        return lambda x: dgcnn_plan(x, k)
    if isinstance(model, PointNet2ClsMsg):
        npoints = (model.sa1.npoint, model.sa2.npoint)
        return lambda x: pointnet2_plan(x, npoints)
    if isinstance(model, PointConvDensityClsSsg):
        spec = [(sa.npoint, sa.nsample, sa.bandwidth)
                for sa in (model.sa1, model.sa2)]
        bandwidth_all = model.sa3.bandwidth
        return lambda x: pointconv_plan(x, spec, bandwidth_all)
    if isinstance(model, PCTCls):
        levels = model.levels
        return lambda x: pct_plan(x, levels)
    if isinstance(model, PointMLP):
        levels = model.levels
        return lambda x: pointmlp_plan(x, levels)
    if isinstance(model, PointNetCls):
        return None
    raise NotImplementedError(f"no plan rule for {type(model).__name__}")


def plan_modes_for(model_name: str) -> frozenset:
    return PLAN_MODES.get(model_name, frozenset())
