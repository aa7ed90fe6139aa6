"""Coalition masking as tensor algebra (counterpart of
``interpret_quality_tpu/attrib/coalitions.py``).

Row semantics (the reference's): for permutation ``order``, row ``r`` of its
(R+1)-row block keeps regions ``order[0..r-1]`` and collapses regions
``order[r..R-1]`` to the cloud centre, so

    v[r] = v({order[0], ..., order[r-1]})        r = 0 .. R
    dv[r] = v[r+1] - v[r]  is the marginal contribution of region order[r].
"""
from __future__ import annotations

import numpy as np
import torch


def keep_matrix_from_orders(orders: np.ndarray) -> np.ndarray:
    """Boolean keep matrix from permutations.

    Args:
      orders: (O, R) int array; each row a permutation of 0..R-1.
    Returns:
      keep: (O, R+1, R) bool; keep[o, r, j] is True iff region j's position
      in order o is strictly less than r.
    """
    orders = np.asarray(orders)
    R = orders.shape[1]
    pos = np.argsort(orders, axis=1)                       # rank of region j
    rows = np.arange(R + 1)[None, :, None]                 # (1, R+1, 1)
    return pos[:, None, :] < rows                          # (O, R+1, R)


def masked_coalitions(data: torch.Tensor, center: torch.Tensor,
                      keep: torch.Tensor, region_id: torch.Tensor) -> torch.Tensor:
    """The masked-coalition batch of one cloud.

    Args:
      data: (N, 3) the (possibly disturbed) cloud.
      center: (3,) the cloud centre.
      keep: (O, R+1, R) bool keep matrix.
      region_id: (N,) int64 region of each point.
    Returns:
      (O * (R+1), N, 3) masked clouds in (order, row) order — the row layout
      of the reference's logits artifacts.
    """
    O, Rp1, _ = keep.shape
    point_keep = keep[:, :, region_id]                     # (O, R+1, N)
    masked = torch.where(point_keep[..., None], data, center)
    return masked.reshape(O * Rp1, data.shape[0], 3)


def interaction_masks(context_keep: torch.Tensor, region_i: int,
                      region_j: int) -> torch.Tensor:
    """Region-level keep masks of the 4-row interaction pattern.

    Row layout per context (reference
    final_point_binary_interaction_logits.py:44-56):
      row 0: S u {i, j};  row 1: S u {i};  row 2: S u {j};  row 3: S.

    Args:
      context_keep: (C, R) bool; True for the regions of context S.
      region_i, region_j: the pair's region indices.
    Returns:
      (C, 4, R) bool keep masks.
    """
    R = context_keep.shape[1]
    regions = torch.arange(R, device=context_keep.device)
    onehot_i = regions == int(region_i)
    onehot_j = regions == int(region_j)
    rows = torch.stack([onehot_i | onehot_j, onehot_i, onehot_j,
                        torch.zeros_like(onehot_i)])         # (4, R)
    return context_keep[:, None, :] | rows[None]


def masked_interaction_batch(data: torch.Tensor, center: torch.Tensor,
                             keep_rows: torch.Tensor,
                             region_id: torch.Tensor) -> torch.Tensor:
    """Apply (C, 4, R) keep masks to one cloud (N, 3): (C * 4, N, 3) masked
    clouds in the reference's row order [S u {i,j}, S u {i}, S u {j}, S]
    per context."""
    point_keep = keep_rows[:, :, region_id]                # (C, 4, N)
    masked = torch.where(point_keep[..., None], data, center)
    return masked.reshape(-1, data.shape[0], 3)


def marginals_by_region(dv: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Reorder per-position marginals (..., O, R) into per-region columns:
    dv[..., o, r] belongs to region orders[o, r]."""
    pos = torch.argsort(orders, dim=1)                     # rank of region j
    return torch.take_along_dim(dv, pos.expand(dv.shape), dim=-1)


def scatter_marginals(dv: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Per-region sums (R,) of the per-row marginals (O, R)."""
    return marginals_by_region(dv, orders).sum(dim=0)
