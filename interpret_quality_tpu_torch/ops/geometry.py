"""Point-cloud geometry primitives on channels-last ``(B, N, C)`` tensors.

Counterpart of ``interpret_quality_tpu/ops/geometry.py`` with the same
semantics:

  * squared distances as ``|x|^2 - 2 x.y + |y|^2`` in the tensors' dtype,
    the product at the matmul precision (``ops.precision.matmul``; the JAX
    function leaves it unpinned) unless the caller pins one;
  * kNN in ascending distance with ties to the lowest index (the order of
    ``jax.lax.top_k`` on negated distances).  ``torch.topk`` promises no tie
    order, so selection is a stable sort;
  * FPS with the first index fixed at 0 and argmax ties to the lowest index;
  * ball query with the sort-and-clamp convention (slots beyond the ball
    filled with the first in-ball index);
  * the Gaussian-KDE density of PointConv.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from .precision import matmul, selection_keys


def square_distance(src: torch.Tensor, dst: torch.Tensor,
                    precision: Optional[str] = None) -> torch.Tensor:
    """Pairwise squared Euclidean distance, (..., N, C) x (..., M, C) -> (..., N, M),
    the product at ``precision`` (None: the process's matmul precision)."""
    inner = matmul(src, dst.transpose(-1, -2), precision)
    s2 = torch.sum(src * src, dim=-1, keepdim=True)            # (..., N, 1)
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)            # (..., M, 1)
    return s2 - 2.0 * inner + d2.transpose(-1, -2)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows along the point axis: (B, N, C), (B, ...) -> (B, ..., C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1,
                       flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def sorted_topk_indices(dist: torch.Tensor, k: int,
                        cls: str = "exact") -> torch.Tensor:
    """Indices of the k smallest values along the last axis, ascending, ties
    to the lowest index; int32.  ``cls``: the kNN selection class, whose
    keys (``precision.selection_keys``) are sorted in place of the values."""
    keys = selection_keys(dist, cls)
    return torch.sort(keys, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours of each point within its own cloud (self
    included): (B, N, C) -> (B, N, k) int32."""
    return sorted_topk_indices(square_distance(x, x), k)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling with the first point fixed at index 0.

    Args:
      xyz: (B, N, 3).
    Returns:
      (B, npoint) int32 indices.
    """
    B, N, _ = xyz.shape
    centroids = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest.to(torch.int32)
        diff = xyz - xyz[rows, farthest][:, None, :]           # (B, N, 3)
        sq = diff * diff
        dist = sq[..., 0] + sq[..., 1] + sq[..., 2]
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, dim=-1)              # first maximum
    return centroids


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     precision: Optional[str] = None) -> torch.Tensor:
    """Ball query with sort-and-clamp semantics.

    Args:
      xyz: (B, N, 3) all points; new_xyz: (B, S, 3) query centres.
    Returns:
      (B, S, min(nsample, N)) int32: the first in-ball indices in index
      order; slots beyond the ball repeat the first in-ball index, and an
      empty ball gives index 0.  In-ball is ``square_distance <= radius**2``
      in the tensors' dtype, the product at ``precision``.
    """
    N = xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz, precision)        # (B, S, N)
    arange = torch.arange(N, dtype=torch.int64, device=xyz.device)
    group_idx = torch.where(sqrdists > radius ** 2, N, arange)
    group_idx = torch.sort(group_idx, dim=-1).values[..., :nsample]
    first = group_idx[..., :1]
    first = torch.where(first == N, 0, first)
    group_idx = torch.where(group_idx == N, first, group_idx)
    return group_idx.to(torch.int32)


def knn_point(nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest points of each query: (B, N, 3), (B, S, 3) -> (B, S, k)
    int32, ascending distance, ties to the lowest index."""
    return sorted_topk_indices(square_distance(new_xyz, xyz), nsample)


DENSITY_CHUNK = 1 << 28      # distances per compute_density chunk (1 GiB f32)


def compute_density(xyz: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """Gaussian-KDE point density, mean_j exp(-d_ij / (2 h^2)) / (2.5 h):
    (B, N, 3) -> (B, N).

    The (B, N, N) distances are taken a chunk of clouds at a time, at most
    ``DENSITY_CHUNK`` of them per chunk: one masked-coalition batch of 1650
    clouds of 1024 points would otherwise hold 6.9 GB.  Each cloud's
    arithmetic is the same either way.  It runs inside the profiler span
    ``iq_density``.
    """
    B, N, _ = xyz.shape
    step = max(1, DENSITY_CHUNK // max(1, N * N))
    out = []
    with record_function("iq_density"):
        for s in range(0, B, step):
            x = xyz[s:s + step]
            g = torch.exp(-square_distance(x, x) / (2.0 * bandwidth * bandwidth))
            out.append(torch.mean(g / (2.5 * bandwidth), dim=-1))
        return torch.cat(out, dim=0)
