"""Interaction plots: |E[I^(m)]| vs order bar charts for normal / adversarial
poses and the most perturbation-sensitive region, plus the 6-model x
2-dataset composite figure.

Replaces reference plot_interaction.py (the port's copy of
``interpret_quality_tpu/results/plots.py``); reads the
ratio<r>_<type>_interaction.npy artifacts of any of the three
implementations.  The plots need matplotlib (the ``agg`` backend), which
is imported when one is drawn: the helpers that read the interaction
arrays need only numpy.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..attrib.interactions import RATIOS, selected_sample_indices
from ..config import MODEL_NAMES, ExperimentConfig
from ..utils.io import mkdir

MODEL_NAMES_SHOW = ["PointNet", "PointNet++", "PointConv", "DGCNN", "GCNN",
                    "adv-GCNN"]


def get_interaction_normal_adv_pose(cfg: ExperimentConfig, mode: str,
                                    names: Sequence[str],
                                    output_type: str = "pred",
                                    ratios: Sequence[float] = tuple(RATIOS),
                                    sample_indices=None):
    """(num_pc, num_ratios) mean interactions at normal and adv poses."""
    indices = (sample_indices if sample_indices is not None
               else selected_sample_indices(cfg.dataset))
    mean_n, abs_n, mean_a, abs_a = [], [], [], []
    for i in indices:
        inter_folder = cfg.exp_folder + f"{names[i]}/interaction_seed{cfg.seed}/"
        row_n, row_an, row_a, row_aa = [], [], [], []
        for ratio in ratios:
            normal = np.load(inter_folder + "normal/ratio%d_%s_interaction.npy"
                             % (int(ratio * 100), output_type))
            adv = np.load(inter_folder + "%s_adv/ratio%d_%s_interaction.npy"
                          % (mode, int(ratio * 100), output_type))
            row_n.append(normal.mean())
            row_an.append(np.abs(normal.mean(axis=1)).mean())
            row_a.append(adv.mean())
            row_aa.append(np.abs(adv.mean(axis=1)).mean())
        mean_n.append(row_n)
        abs_n.append(row_an)
        mean_a.append(row_a)
        abs_a.append(row_aa)
    return (np.array(mean_n), np.array(abs_n),
            np.array(mean_a), np.array(abs_a))


def get_interaction_single_region(cfg: ExperimentConfig, mode: str,
                                  names: Sequence[str],
                                  output_type: str = "pred",
                                  ratios: Sequence[float] = tuple(RATIOS),
                                  sample_indices=None):
    """(num_pc, 1, num_ratios) interactions of the rank-1 (most sensitive)
    region at the normal pose."""
    indices = (sample_indices if sample_indices is not None
               else selected_sample_indices(cfg.dataset))
    all_mean, all_abs = [], []
    for i in indices:
        single_folder = (cfg.exp_folder + f"{names[i]}/"
                         + f"interaction_seed{cfg.seed}/{mode}_adv_single_region/")
        pose_mean, pose_abs = [], []
        for rf in sorted(os.listdir(single_folder)):
            if not os.path.isdir(single_folder + rf) or int(rf[10:12]) != 1:
                continue
            first = (single_folder + rf + "/normal/ratio%d_%s_interaction.npy"
                     % (int(ratios[0] * 100), output_type))
            if not os.path.exists(first):
                # rank-1 region had no ball-query neighbours -> no pairs were
                # generated and the logits/score stages skipped it
                continue
            row_m, row_a = [], []
            for ratio in ratios:
                inter = np.load(single_folder + rf
                                + "/normal/ratio%d_%s_interaction.npy"
                                % (int(ratio * 100), output_type))
                row_m.append(inter.mean())
                row_a.append(np.abs(inter.mean(axis=1)).mean())
            pose_mean.append(row_m)
            pose_abs.append(row_a)
        if not pose_mean:      # keep the (num_pc, 1, ratios) shape: zeros
            pose_mean = [[0.0] * len(ratios)]
            pose_abs = [[0.0] * len(ratios)]
        all_mean.append(pose_mean)
        all_abs.append(pose_abs)
    return np.array(all_mean), np.array(all_abs)


def _pyplot():
    """matplotlib.pyplot on the ``agg`` backend."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    return plt


def _bar_double(ax, orders, a, b, title=None, color2=None, labels=None):
    w = 0.035
    ax.bar(orders, a, w, label=(labels[0] if labels else None), color="#4169E1")
    ax.bar(orders + w + 0.005, b, w, label=(labels[1] if labels else None),
           color=color2)
    ax.set_xlabel("order")
    ax.set_ylabel("interaction")
    ax.set_xticks(np.array([0, 1.2]) + w / 2)
    ax.set_xticklabels(["0", "n-2"])
    if title:
        ax.set_title(title)
    if labels:
        ax.legend()


def plot_single_region_vs_normal_avg(cfg: ExperimentConfig, mode: str,
                                     names: Sequence[str],
                                     output_type: str = "pred",
                                     fig_root: str = "figures",
                                     sample_indices=None):
    mean_sr, abs_sr = get_interaction_single_region(
        cfg, mode, names, output_type, sample_indices=sample_indices)
    mean_n, abs_n, mean_a, abs_a = get_interaction_normal_adv_pose(
        cfg, mode, names, output_type, sample_indices=sample_indices)
    save_dir = f"{fig_root}/interaction_final_{cfg.dataset}/"
    mkdir(save_dir)
    for tag, arr in [("mean_inter_single_region", mean_sr),
                     ("abs_mean_inter_single_region", abs_sr),
                     ("mean_inter_normal", mean_n),
                     ("abs_mean_inter_normal", abs_n),
                     ("mean_inter_adv", mean_a),
                     ("abs_mean_inter_adv", abs_a)]:
        np.save(save_dir + f"{cfg.model}_{cfg.dataset}_{tag}.npy", arr)

    orders = np.arange(0, 1.3, 0.1)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5), dpi=200)
    _bar_double(ax, orders, np.abs(mean_n).mean(axis=0),
                np.abs(mean_sr[:, 0, :]).mean(axis=0), color2="y")
    fig.tight_layout()
    out = (save_dir + "single_region_top_range_compare_%s_%s_%s_seed%d_all_pc.png"
           % (cfg.model, mode, output_type, cfg.seed))
    plt.savefig(out)
    plt.close()
    return out


def plot_normal_vs_adv(cfg: ExperimentConfig, mode: str, names: Sequence[str],
                       output_type: str = "pred", fig_root: str = "figures",
                       sample_indices=None):
    mean_n, _, mean_a, _ = get_interaction_normal_adv_pose(
        cfg, mode, names, output_type, sample_indices=sample_indices)
    orders = np.arange(0, 1.3, 0.1)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5), dpi=200)
    _bar_double(ax, orders, np.abs(mean_n).mean(axis=0),
                np.abs(mean_a).mean(axis=0),
                labels=["$I^{(m)}_{nor}$", "$I^{(m)}_{adv}$"])
    fig.tight_layout()
    save_dir = f"{fig_root}/interaction_final_{cfg.dataset}/"
    mkdir(save_dir)
    out = (save_dir + "global_in_one_%s_%s_%s_seed%d_all_pc.png"
           % (cfg.model, mode, output_type, cfg.seed))
    plt.savefig(out)
    plt.close()
    return out


def plot_all_models(fig_root: str = "figures",
                    datasets=("modelnet10", "shapenet"),
                    model_names=tuple(MODEL_NAMES)):
    """Composite figure: |E[I^(m)]| for all models on both datasets,
    normal vs adv (top) and all-regions vs most-sensitive-region (bottom)."""
    orders = np.arange(0, 1.3, 0.1)
    nmodels = len(model_names)
    plt = _pyplot()
    fig, axes = plt.subplots(2 * len(datasets), nmodels,
                             figsize=(5 * nmodels, 16), dpi=100)
    # one model or one row yields a 1-D array: (rows, models) whatever the
    # sizes (the JAX package's np.atleast_2d turns a column into a row)
    axes = np.asarray(axes).reshape(2 * len(datasets), nmodels)
    for di, dataset in enumerate(datasets):
        save_dir = f"{fig_root}/interaction_final_{dataset}/"
        for mi, model_name in enumerate(model_names):
            base = save_dir + f"{model_name}_{dataset}_mean_inter_"
            if not all(os.path.exists(base + s + ".npy")
                       for s in ("normal", "adv", "single_region")):
                # aggregates not (fully) generated for this model/dataset
                # (run plot_mode=single_region_vs_normal_avg first)
                print(f"  {base}*.npy incomplete, panel skipped")
                continue
            normal = np.load(base + "normal.npy")
            adv = np.load(base + "adv.npy")
            sr = np.load(base + "single_region.npy")
            _bar_double(axes[di, mi], orders, np.abs(normal).mean(axis=0),
                        np.abs(adv).mean(axis=0),
                        title=f"{MODEL_NAMES_SHOW[mi]} ({dataset})",
                        color2="#FF7F24")
            _bar_double(axes[len(datasets) + di, mi], orders,
                        np.abs(normal).mean(axis=0),
                        np.abs(sr[:, 0, :]).mean(axis=0), color2="#A2CD5A")
    fig.tight_layout()
    save_dir = f"{fig_root}_show/interaction_all/"
    mkdir(save_dir)
    out = save_dir + "interaction_all.pdf"
    plt.savefig(out)
    plt.close()
    return out
