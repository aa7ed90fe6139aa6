"""Results aggregation: the paper's Tables 2-4 (the port's copy of
``interpret_quality_tpu/results/tables.py``).

Pure numpy post-processing over the artifact tree; reads the port's
artifacts, the JAX package's or the reference's (one schema).

  * Table 2 sensitivity: per-region (max-min over poses) normalised by the
    mean L1 norm of all Shapley vectors (reference final_result.py:83-120).
  * Table 3 correlation: Pearson r between sensitivity and mean |phi|
    intensity per sample (final_result.py:124-140).
  * Table 4 spatial smoothness: mean |phi_i − phi_neighbours| over ball-query
    neighbours, normalised by mean |sum phi| (final_result.py:144-211).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import pearsonr

from ..config import BALL_QUERY_COEF, ExperimentConfig
from ..utils.region_geom import region_ball_neighbors

MODES_ALL = ["rotate", "trans", "scale", "linearity", "planarity", "scattering"]
SMOOTH_MODES = ("linearity", "planarity", "scattering")


def _load_region_sv(base_folder: str, mode: str) -> np.ndarray:
    """(num_poses, num_regions) Shapley values for a sample and mode; the
    smoothness modes concatenate the inc and dec runs."""
    if any(m in mode for m in SMOOTH_MODES):
        inc = np.load(base_folder + f"{mode}_all/allregion_inc/region_shapley_value.npy")
        dec = np.load(base_folder + f"{mode}_all/allregion_dec/region_shapley_value.npy")
        return np.concatenate([inc, dec], axis=0)
    return np.load(base_folder + f"{mode}_all/region_shapley_value.npy")


def cal_sensitivity(base_folder: str, mode: str) -> np.ndarray:
    """(num_regions,) normalised range of one sample."""
    sv = _load_region_sv(base_folder, mode)
    denominator = np.mean(np.sum(np.abs(sv), axis=1))
    range_per_region = sv.max(axis=0) - sv.min(axis=0)
    if denominator == 0:    # all-zero attributions (degenerate toy runs):
        return range_per_region      # the range is 0 too — report it as-is
    return range_per_region / denominator


def cal_sensitivity_all_pc(cfg: ExperimentConfig, mode: str,
                           names: Sequence[str]) -> np.ndarray:
    """(num_pc, num_regions) sensitivities for all eval samples."""
    return np.array([cal_sensitivity(cfg.exp_folder + f"{n}/", mode)
                     for n in names])


def cal_mean_sv_intensity(cfg: ExperimentConfig, mode: str,
                          names: Sequence[str]) -> np.ndarray:
    """(num_pc, num_regions) mean |phi| per region over poses."""
    assert mode in ("trans", "rotate", "scale")
    out = []
    for n in names:
        sv = np.load(cfg.exp_folder + f"{n}/{mode}_all/region_shapley_value.npy")
        out.append(np.mean(np.abs(sv), axis=0))
    return np.array(out)


def cal_correlation_coef(cfg: ExperimentConfig, mode: str,
                         names: Sequence[str]) -> Tuple[float, float]:
    """Mean and std of per-sample Pearson r between sensitivity and mean
    |phi| intensity."""
    sens = cal_sensitivity_all_pc(cfg, mode, names)
    intensity = cal_mean_sv_intensity(cfg, mode, names)
    rs = np.array([pearsonr(sens[i], intensity[i])[0]
                   for i in range(len(names))])
    return float(rs.mean()), float(rs.std(ddof=1))


def cal_shapley_smoothness_metric_single_pc(
        data: np.ndarray, region_shapley_values: np.ndarray,
        region_id: np.ndarray, num_regions: int = 32):
    """Spatial-smoothness metric of one sample.

    Returns (metric, metric_all_poses (num_poses,), denominator).
    """
    num_poses = region_shapley_values.shape[0]
    neighbor_idx = region_ball_neighbors(data, region_id, num_regions,
                                         BALL_QUERY_COEF)

    denominator = np.abs(np.sum(region_shapley_values, axis=1)).mean()
    denominator = denominator if denominator else 1.0   # all-zero phi
    # vectorised over poses; regions without neighbours (empty regions at
    # toy scales) are excluded instead of NaN-poisoning the mean
    keep = neighbor_idx.any(axis=1)
    all_fraction = np.zeros((num_poses, int(keep.sum())))
    for col, i in enumerate(np.flatnonzero(keep)):
        diff = np.abs(region_shapley_values[:, i:i + 1]
                      - region_shapley_values[:, neighbor_idx[i]])
        all_fraction[:, col] = diff.mean(axis=1) / denominator
    return all_fraction.mean(), all_fraction.mean(axis=1), denominator


def cal_shapley_smoothness_metric(cfg: ExperimentConfig, mode: str,
                                  dataset, names: Sequence[str],
                                  skip_prefix: str = "Knife"):
    """Mean ± std spatial smoothness over all samples (Knife category skipped
    for ShapeNet, reference final_result.py:200)."""
    metrics = []
    for pc_idx in range(len(dataset)):
        name = names[pc_idx]
        if name[:len(skip_prefix)] == skip_prefix:
            continue
        base_folder = cfg.exp_folder + f"{name}/"
        data, _ = dataset[pc_idx]
        region_id = np.load(base_folder + "region_id.npy")
        sv = np.load(base_folder + f"{mode}_all/region_shapley_value.npy")
        metric, _, _ = cal_shapley_smoothness_metric_single_pc(
            np.asarray(data), sv, region_id, cfg.num_regions)
        metrics.append(metric)
    metrics = np.array(metrics)
    return float(metrics.mean()), float(metrics.std(ddof=1))
