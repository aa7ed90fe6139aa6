"""Pipeline stages: FPS partition, Shapley initialisation, perturbation
enumeration (counterpart of ``interpret_quality_tpu/attrib/stages.py``).
Each stage writes the reference artifact schema under ``cfg.exp_folder``.

Reference call stacks replaced here:
  * final_save_fps.py:34-54         -> save_fps
  * final_shapley_value.py:110-156  -> run_shapley_init
  * tools/final_common.py:107-174   -> run_enum (trans/rotate/scale scripts)
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from ..config import ExperimentConfig
from ..models.common import resolve_device
from ..models.plans import plan_modes_for
from ..ops.geometry import farthest_point_sample
from ..pipeline import load_frozen_model, make_engine, resolve_dataset
from ..utils.io import IOStream, mkdir, save_npy, save_torch_tensor
from ..utils.profiling import StageTimer, device_trace
from ..utils.rng import set_random
from .perturbations import MODES
from .shapley import generate_all_orders, norm_factor, region_id_from_fps

SNAPSHOT_COUNTS = [100, 200, 300, 400, 500, 600, 700, 800, 900, 1000,
                   2000, 3000, 4000, 5000]


# ---------------------------------------------------------------------------
# FPS region partition
# ---------------------------------------------------------------------------
def save_fps(cfg: ExperimentConfig, synthetic: bool = False,
             out_path: Optional[str] = None) -> np.ndarray:
    """FPS indices of the region centres for all 30 eval clouds."""
    device = resolve_device(cfg.device)
    dataset, _ = resolve_dataset(cfg, synthetic)
    clouds = np.stack([dataset[i][0] for i in range(len(dataset))])  # (30,N,3)
    fps_index = farthest_point_sample(torch.from_numpy(clouds).to(device),
                                      cfg.num_regions).cpu().numpy()
    save_npy(out_path or cfg.fps_index_path(), fps_index)
    return fps_index


# ---------------------------------------------------------------------------
# Shapley initialisation
# ---------------------------------------------------------------------------
def run_shapley_init(cfg: ExperimentConfig, synthetic: bool = False,
                     allow_random_init: bool = False,
                     sample_indices: Optional[list] = None,
                     resume: bool = False, antithetic: bool = False,
                     coalition_devices: Optional[Sequence] = None,
                     trace_dir: Optional[str] = None):
    """Per eval cloud: region ids, norm factor, saved permutations, the
    ``num_samples_save``-order Shapley estimate with convergence snapshots,
    and the per-order estimates (region_sv_all.npy).

    ``antithetic=True`` samples the permutations in (pi, reverse pi) pairs;
    the artifacts are unchanged.  ``coalition_devices`` splits the
    coalition batches over those devices (``pipeline.split_forward``);
    ``trace_dir`` writes a ``torch.profiler`` trace of each cloud's
    estimate there."""
    set_random(cfg.seed)
    dataset, names = resolve_dataset(cfg, synthetic)
    _, forward, device = load_frozen_model(cfg, allow_random_init)
    engine = make_engine(cfg, forward, device, coalition_devices)

    fps_path = cfg.fps_index_path()
    if not os.path.exists(fps_path):
        save_fps(cfg, synthetic, fps_path)
    fps_indices = np.load(fps_path)

    indices = sample_indices if sample_indices is not None else range(len(dataset))
    sampling_mode = "antithetic" if antithetic else "iid"
    for i in indices:
        data, lbl = dataset[i]
        result_path = cfg.exp_folder + f"{names[i]}/"
        if resume and os.path.exists(result_path + "region_sv_all.npy"):
            mode_path = result_path + "orders_mode.txt"
            saved_mode = "iid"
            if os.path.exists(mode_path):
                with open(mode_path) as f:
                    saved_mode = f.read().strip()
            if saved_mode != sampling_mode:
                print(f"[shapley_init] WARNING: {names[i]} resumed with "
                      f"{saved_mode} permutations but this run samples "
                      f"{sampling_mode} — streams are mixed across clouds")
            print(f"[shapley_init] {names[i]}: artifacts exist, skipping")
            continue
        mkdir(result_path)
        with open(result_path + "orders_mode.txt", "w") as f:
            f.write(sampling_mode + "\n")
        with IOStream(result_path + "log.txt", "w") as io:
            region_id = region_id_from_fps(
                torch.from_numpy(data).to(device),
                torch.from_numpy(fps_indices[i]).to(device)).cpu().numpy()
            save_npy(result_path + "region_id.npy", region_id)

            nf = norm_factor(engine.forward_fn, data, lbl, cfg.softmax_type,
                             engine.device)
            save_npy(result_path + "norm_factor.npy", nf)

            all_orders = generate_all_orders(cfg.num_samples_save,
                                             cfg.num_regions,
                                             antithetic=antithetic)
            save_npy(result_path + "all_orders.npy", all_orders)

            with device_trace(trace_dir, f"shapley_init_{names[i]}"), \
                    StageTimer(f"shapley_init:{names[i]}",
                               items=cfg.num_samples_save
                               * (cfg.num_regions + 1), printer=io.cprint):
                _, per_order = engine.shapley_for_pose(
                    data, lbl, region_id, all_orders, return_per_order=True)
        save_npy(result_path + "region_sv_all.npy", per_order)

        cumsum = np.cumsum(per_order, axis=0)          # (S, R)
        counts = [c for c in SNAPSHOT_COUNTS if c <= cfg.num_samples_save]
        if cfg.num_samples_save not in counts:
            counts.append(cfg.num_samples_save)   # always snapshot the final
        for count in counts:
            _save_snapshot(cumsum[count - 1], i, count, result_path, region_id)


def _save_snapshot(region_sv_sum, pc_idx, count, result_path, region_id):
    """Per-point and per-region snapshots (reference final_shapley_value.py:91-106)."""
    folder = result_path + "shapley/"
    folder2 = result_path + "region_shapley/"
    mkdir(folder)
    mkdir(folder2)
    region_avg = region_sv_sum / count
    save_npy(folder + f"{pc_idx}_{count}.npy", region_avg[np.asarray(region_id)])
    save_npy(folder2 + f"{pc_idx}_{count}.npy", region_avg)


# ---------------------------------------------------------------------------
# Perturbation enumeration (trans / rotate / scale)
# ---------------------------------------------------------------------------
def run_enum(cfg: ExperimentConfig, mode_name: str, synthetic: bool = False,
             allow_random_init: bool = False, save_logits: bool = True,
             sample_indices: Optional[list] = None, resume: bool = False,
             max_poses: Optional[int] = None,
             coalition_devices: Optional[Sequence] = None,
             trace_dir: Optional[str] = None):
    """Recompute Shapley values at every pose of a perturbation grid.

    Where ``models.plans.PLAN_MODES`` allows it for (model, mode), and
    ``IQTPU_ENUM_PLAN`` is not 0 (``config.enum_plan``), the graph is built
    once per order chunk and reused for every pose
    (``ShapleyEngine.enum_all_poses_plan``); otherwise it is rebuilt in every
    forward (``enum_all_poses``).  ``coalition_devices`` and ``trace_dir``
    as in ``run_shapley_init`` (a trace of each cloud's pose grid)."""
    set_random(cfg.seed)
    mode = MODES[mode_name]
    dataset, names = resolve_dataset(cfg, synthetic)
    _, forward, device = load_frozen_model(cfg, allow_random_init)
    engine = make_engine(cfg, forward, device, coalition_devices)

    all_params = mode.generate_params()                 # (P, 3) or (P,)
    if max_poses is not None:
        all_params = all_params[:max_poses]
    use_plan = mode_name in plan_modes_for(cfg.model) and config.enum_plan()

    indices = sample_indices if sample_indices is not None else range(len(dataset))
    for pc_index in indices:
        data, lbl = dataset[pc_index]
        base_folder = cfg.exp_folder + f"{names[pc_index]}/"
        mode_folder = base_folder + f"{mode_name}_all/"
        if resume and os.path.exists(mode_folder + "region_shapley_value.npy"):
            print(f"[enum:{mode_name}] {names[pc_index]}: artifacts exist, skipping")
            continue
        mkdir(mode_folder)
        with IOStream(mode_folder + "log.txt", "w") as io:
            io.cprint(str(cfg))
            nf = np.load(base_folder + "norm_factor.npy")
            io.cprint("norm factor: %f" % nf)
            region_id = np.load(base_folder + "region_id.npy")
            orders = np.load(base_folder + "all_orders.npy")[:cfg.num_samples]

            orig_sv = engine.shapley_for_pose(data, lbl, region_id, orders)
            io.cprint("origin region shapley: %s" % str(orig_sv))
            save_npy(mode_folder + "orig_shapley_value.npy", orig_sv)

            P = all_params.shape[0]
            timer = StageTimer(f"enum:{mode_name}:{names[pc_index]}",
                               items=P * orders.shape[0] * (cfg.num_regions + 1),
                               printer=io.cprint)
            with device_trace(trace_dir,
                              f"enum_{mode_name}_{names[pc_index]}"), timer:
                if use_plan:
                    region_shapley_list, all_logits = engine.enum_all_poses_plan(
                        mode.disturb_fn, data, all_params, lbl, region_id,
                        orders, engine.forward_fn.plan_fn,
                        engine.forward_fn.apply_plan_fn,
                        return_logits=save_logits)
                else:
                    region_shapley_list, all_logits = engine.enum_all_poses(
                        mode.disturb_fn, data, all_params, lbl, region_id,
                        orders, return_logits=save_logits)
            for pose in range(P):
                io.cprint("pose %d %s: shapley %s"
                          % (pose, str(np.asarray(all_params[pose])),
                             str(region_shapley_list[pose])))

            save_npy(mode_folder + "region_shapley_value.npy", region_shapley_list)
            if save_logits:
                save_torch_tensor(mode_folder + "all_logits.pt", all_logits)
            mode.save_info(all_params, mode_folder)
            io.cprint("time: %f" % timer.seconds)
