"""Numpy region geometry (the port's copy of
``interpret_quality_tpu/utils/region_geom.py``).

Region centres and the centre ball-query neighbour mask, used by the
single-region interaction generator (reference final_gen_pair.py:145-218).
A region can end up with no points at toy scales (duplicate FPS centres tie
the argmin to the lower index); its centre is then invalid instead of the
NaN mean of an empty slice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def sqdist_np(x: np.ndarray) -> np.ndarray:
    """(M, M) pairwise squared distances of rows of (M, D) x."""
    xx = np.sum(x ** 2, axis=1, keepdims=True)
    return xx + xx.T - 2 * (x @ x.T)


def region_centers_np(data: np.ndarray, region_id: np.ndarray,
                      num_regions: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-region mean points.

    Returns:
      centers: (R, D); rows of empty regions are zeros (see ``valid``).
      valid: (R,) bool; False for regions with no assigned points.
    """
    centers = np.zeros((num_regions, data.shape[1]))
    valid = np.zeros(num_regions, bool)
    for i in range(num_regions):
        pts = data[region_id == i]
        if len(pts):
            centers[i] = pts.mean(axis=0)
            valid[i] = True
    return centers, valid


def region_ball_neighbors(data: np.ndarray, region_id: np.ndarray,
                          num_regions: int, coef: float) -> np.ndarray:
    """(R, R) bool: regions whose centres lie within ``coef * diameter`` of
    each other (incl. self).  Empty regions have no neighbours and are no
    region's neighbour."""
    centers, valid = region_centers_np(data, region_id, num_regions)
    diameter = float(np.sqrt(np.maximum(sqdist_np(data), 0)).max())
    nb = sqdist_np(centers) < (coef * diameter) ** 2
    nb[~valid, :] = False
    nb[:, ~valid] = False
    return nb
