"""What the inputs of a forward need, counted from the inputs themselves,
for the per-layer readers that turn counts into operations and bytes.

A masked cloud's collapsed points are one point many times over: every
layer computes the same rows for them.  So a cloud's distinct points are
its kept points, plus one where any point collapsed (``distinct_points``).
A family whose work is counted in more than distinct points (PointNet++'s
balls) counts it in its reference module's ``extra_counts``.
"""
from __future__ import annotations

import numpy as np
import torch

from iqbench.reference import attribution as ref_attr


def distinct_points(keep_rows: np.ndarray, region: np.ndarray) -> np.ndarray:
    """(M,) distinct points of the masked clouds of keep rows (M, R)."""
    sizes = np.bincount(region, minlength=keep_rows.shape[1])
    kept = keep_rows.astype(np.int64) @ sizes
    return kept + (kept < len(region))


def chunk_counts(cfg, masked: torch.Tensor, keep_rows: np.ndarray,
                 region: np.ndarray) -> dict:
    """Counts of one batch of masked clouds (M, N, 3) made by keep rows
    (M, R): ``clouds``, ``d`` (each cloud's distinct points) and what the
    reference module's ``extra_counts`` adds, given each point's identity
    (its index where kept, N for every collapsed point)."""
    keep_rows = keep_rows.reshape(-1, keep_rows.shape[-1])
    out = {"clouds": len(keep_rows), "d": distinct_points(keep_rows, region)}
    extra = getattr(ref_attr.model(cfg), "extra_counts", None)
    if extra is not None:
        N = len(region)
        kept = torch.from_numpy(keep_rows[:, region]).to(masked.device)
        ident = torch.where(kept, torch.arange(N, device=masked.device), N)
        out.update(extra(cfg, masked, ident))
    return out


def enum_chunk_keep(orders: np.ndarray) -> np.ndarray:
    """The keep rows of an order chunk, (O * (R+1), R)."""
    return ref_attr.keep_matrix(orders).reshape(-1, orders.shape[1])
