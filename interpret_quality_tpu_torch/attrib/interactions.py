"""Multi-order pairwise interaction pipeline (counterpart of
``interpret_quality_tpu/attrib/interactions.py``).

Three stages, replacing the reference CLI chain
(final_gen_pair.py -> final_point_binary_interaction_logits.py ->
final_cal_interactions.py):

  1. ``run_gen_pair`` — sample region pairs and contexts (host numpy on the
     global stream, with the reference's seeding), find the adversarial pose
     among the enumeration grid, save predicted labels.
  2. ``run_interaction_logits`` — for every (pair, context) build the 4-row
     masked batch [S∪{i,j}, S∪{i}, S∪{j}, S] from region keep masks and
     forward it; ``batch_contexts`` cells per forward.
  3. ``run_cal_interactions`` — host post-processing:
     I = v(S∪{i,j}) + v(S) − v(S∪{i}) − v(S∪{j}).

Artifact schema as the reference's (interaction_seed<k>/...,
ratio<r>_context_list.npy, ratio<r>_all_logits.pt,
ratio<r>_{gt,pred}_interaction.npy).
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from scipy.special import comb
from torch.profiler import record_function

from ..config import (BALL_QUERY_COEF, ExperimentConfig,
                      MODELNET_INTER_SELECTED_SAMPLE,
                      SHAPENET_INTER_SELECTED_SAMPLE)
from ..pipeline import load_frozen_model, resolve_dataset, split_forward
from ..utils.io import (IOStream, load_torch_tensor, mkdir, save_npy,
                        save_torch_tensor)
from ..utils.profiling import StageTimer, device_trace
from ..utils.region_geom import region_ball_neighbors
from ..utils.rng import cal_rank, set_random
from .coalitions import masked_interaction_batch
from .perturbations import MODES
from .reward import reward_from_logits, reward_from_logits_np

RATIOS = [0., 0.04, 0.07, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.]
NUM_PAIRS_RANDOM = 300
NUM_SAVE_CONTEXT_MAX = 100


def selected_sample_indices(dataset: str) -> List[int]:
    return (MODELNET_INTER_SELECTED_SAMPLE if dataset == "modelnet10"
            else SHAPENET_INTER_SELECTED_SAMPLE)


def gen_pair_random(num_regions: int, num_pairs: int) -> np.ndarray:
    """Random (i, j) pairs, i < j (reference final_gen_pair.py:288-300).
    Fewer than ``num_pairs`` distinct pairs (a reduced region count) clamps
    the count with a warning, where the reference would raise."""
    all_pairs = np.array([[i, j] for i in range(num_regions)
                          for j in range(num_regions) if j > i])
    if num_pairs > all_pairs.shape[0]:
        print(f"[gen_pair] WARNING: only {all_pairs.shape[0]} distinct "
              f"pairs exist at this region count; clamping num_pairs from "
              f"{num_pairs}")
    num_pairs = min(num_pairs, all_pairs.shape[0])
    idx = np.random.choice(all_pairs.shape[0], size=num_pairs, replace=False)
    return all_pairs[idx]


def gen_context(region_pair_list: np.ndarray, save_path: str,
                num_regions: int, ratios: Sequence[float] = tuple(RATIOS),
                num_save_context_max: int = NUM_SAVE_CONTEXT_MAX):
    """Contexts S ⊆ N∖{i,j} of size m = ⌊(R-2)·ratio⌋ per pair
    (reference final_gen_pair.py:18-43): every combination where there are
    at most ``num_save_context_max``, else that many random draws."""
    for ratio in ratios:
        context_list = []
        m = int((num_regions - 2) * ratio)
        for pair in region_pair_list:
            all_s = [r for r in range(num_regions) if r not in (pair[0], pair[1])]
            if comb(len(all_s), m) > num_save_context_max:
                ctx = [np.random.choice(all_s, m, replace=False)
                       for _ in range(num_save_context_max)]
            else:
                ctx = list(itertools.combinations(all_s, m))
            context_list.append(ctx)
        context_list = np.array(context_list)     # (num_pairs, num_context, m)
        save_npy(save_path + "ratio%d_context_list.npy" % int(ratio * 100),
                 context_list)


def gen_pair_single_region(region: int, neighbor_idx: np.ndarray,
                           num_regions: int) -> np.ndarray:
    pairs = [[region, n] for n in np.arange(num_regions)[neighbor_idx[region]]
             if n != region]
    return np.array(pairs)


# ---------------------------------------------------------------------------
# stage 1: pair / context / adv-pose generation
# ---------------------------------------------------------------------------
def run_gen_pair(cfg: ExperimentConfig, mode_name: str = "rotate",
                 synthetic: bool = False, allow_random_init: bool = False,
                 ratios: Sequence[float] = tuple(RATIOS),
                 num_pairs_random: int = NUM_PAIRS_RANDOM,
                 num_save_context_max: int = NUM_SAVE_CONTEXT_MAX,
                 sample_indices: Optional[list] = None):
    """Pairs, contexts, adversarial and per-region max/min poses, and the
    predicted labels there, for every eval cloud (reference
    final_gen_pair.py:106; ``sample_indices`` restricts the clouds).  Reads
    the ``<mode>_all/`` enumeration of each cloud."""
    set_random(cfg.seed)
    mode = MODES[mode_name]
    dataset, names = resolve_dataset(cfg, synthetic)
    _, forward, device = load_frozen_model(cfg, allow_random_init)

    indices = sample_indices if sample_indices is not None else range(len(dataset))
    for pc_idx in indices:
        data, lbl = dataset[pc_idx]
        name = names[pc_idx]
        base_folder = cfg.exp_folder + f"{name}/"
        mode_folder = base_folder + f"{mode_name}_all/"
        inter_folder = base_folder + f"interaction_seed{cfg.seed}/"
        single_region_folder = inter_folder + f"{mode_name}_adv_single_region/"
        mkdir(inter_folder + "normal/")
        mkdir(inter_folder + f"{mode_name}_adv/")
        mkdir(single_region_folder)

        # ---- random pairs (shared by normal and adv pose)
        region_pair_list = gen_pair_random(cfg.num_regions, num_pairs_random)
        save_npy(inter_folder + "region_pair_list.npy", region_pair_list)

        # ---- adversarial pose: argmin reward over the enumeration grid
        #      (reference final_gen_pair.py:221-286)
        params_file = {"trans": "trans_vector.npy",
                       "scale": "scale.npy"}.get(mode_name, "angle_tuple.npy")
        all_params = np.load(mode_folder + params_file)
        x = torch.from_numpy(data).to(device)
        with torch.inference_mode():
            logits = forward(torch.stack([
                mode.disturb_fn(x, p)
                for p in torch.from_numpy(all_params).to(device)]))   # (P, C)
            v = reward_from_logits(logits, lbl, cfg.softmax_type).cpu().numpy()
            pred = logits.argmax(dim=1).cpu().numpy()
        print(f"[gen_pair] {name}: {int((pred != lbl).sum())} poses misclassified")
        pose_idx = int(np.argmin(v))
        save_npy(inter_folder + f"{mode_name}_adv/pose_idx.npy", pose_idx)
        save_npy(inter_folder + f"{mode_name}_adv/transform_params.npy",
                 all_params[pose_idx])

        # ---- single-region pairs: most perturbation-sensitive region and
        #      its ball-query neighbours (reference final_gen_pair.py:145-218)
        region_id = np.load(base_folder + "region_id.npy")
        region_shapley_values = np.load(mode_folder + "region_shapley_value.npy")
        max_pose_idx = np.argmax(region_shapley_values, axis=0)
        min_pose_idx = np.argmin(region_shapley_values, axis=0)
        range_per_region = (region_shapley_values.max(0)
                            - region_shapley_values.min(0))
        range_rank = cfg.num_regions - cal_rank(range_per_region)
        neighbor_idx = region_ball_neighbors(data, region_id, cfg.num_regions,
                                             BALL_QUERY_COEF)
        for region in range(cfg.num_regions):
            region_folder = (single_region_folder
                             + "range_rank%02d_region%02d/" % (range_rank[region],
                                                               region))
            mkdir(region_folder + "normal/")
            for pose, idx in (("max_pose", max_pose_idx[region]),
                              ("min_pose", min_pose_idx[region])):
                mkdir(region_folder + pose + "/")
                save_npy(region_folder + pose + "/transform_params.npy",
                         all_params[idx])
                save_npy(region_folder + pose + "/pose_idx.npy", idx)
            save_npy(region_folder + "region_pair_list.npy",
                     gen_pair_single_region(region, neighbor_idx,
                                            cfg.num_regions))

        # ---- contexts for random pairs and single-region pairs
        gen_context(region_pair_list, inter_folder, cfg.num_regions, ratios,
                    num_save_context_max)
        region_folders = [single_region_folder + rf + "/"
                          for rf in sorted(os.listdir(single_region_folder))
                          if os.path.isdir(single_region_folder + rf)]
        for region_folder in region_folders:
            pair_list = np.load(region_folder + "region_pair_list.npy")
            if len(pair_list) == 0:
                continue
            gen_context(pair_list, region_folder, cfg.num_regions, ratios,
                        num_save_context_max)

        # ---- predicted labels at the adv / max / min poses, one forward
        save_paths = [inter_folder + f"{mode_name}_adv/"] + [
            f + pose for f in region_folders for pose in ("max_pose/", "min_pose/")]
        with torch.inference_mode():
            posed = torch.stack([mode.disturb_fn(x, torch.from_numpy(
                np.load(p + "transform_params.npy").astype(np.float32)).to(device))
                for p in save_paths])
            preds = forward(posed).argmax(dim=1).cpu().numpy()
        for save_path, p in zip(save_paths, preds):
            with open(save_path + "pred_labels.txt", "w") as f:
                f.write("lbl: %d\npred_lbl: %d\n" % (lbl, p))
            save_npy(save_path + "pred_labels.npy", np.array([lbl, p]))


# ---------------------------------------------------------------------------
# stage 2: interaction logits
# ---------------------------------------------------------------------------
class InteractionEngine:
    """Batched 4-row masked forwards for (pair, context) grids.

    All (pair, context) cells of a ratio are flattened into one list of keep
    masks, uploaded once, and forwarded ``batch_contexts`` cells (4 *
    ``batch_contexts`` clouds) at a time; the last chunk is shorter.  The
    logits reach the host once per call.  Its stages run inside the
    profiler spans of ``ShapleyEngine``'s: ``iq_engine.keep`` (the inputs
    and keep masks, built on the host and uploaded), ``iq_engine.mask``
    (each chunk's masked batch), ``iq_forward`` (its forward) and
    ``iq_engine.to_host``; it computes no reward or marginals.

    Args:
      forward_fn: ``(B, N, 3) -> (B, num_class)`` logits on ``device``:
        the model's ``ForwardFn``, or its split over devices
        (``parallel.SplitForward``, logits on its first device).
      num_regions: R.
      batch_contexts: cells per forward.
      device: where the clouds, masks and logits live.
    """

    def __init__(self, forward_fn: Callable, num_regions: int,
                 batch_contexts: int = 100, device="cuda"):
        self.forward_fn = forward_fn
        self.num_regions = num_regions
        self.batch_contexts = batch_contexts
        self.device = torch.device(device)

    def _tensor(self, x, dtype) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))         # a copy: inputs may be read-only
        return x.to(device=self.device, dtype=dtype)

    def _keep_rows_np(self, region_pair_list, context_list) -> np.ndarray:
        """(P*C, 4, R) bool keep masks for every (pair, context), in the
        reference row order [S∪{i,j}, S∪{i}, S∪{j}, S]."""
        P, C = context_list.shape[0], context_list.shape[1]
        R = self.num_regions
        ctx_keep = np.zeros((P, C, R), bool)
        if context_list.shape[2] > 0:              # m = 0: every S is empty
            p_idx = np.repeat(np.arange(P), C * context_list.shape[2])
            c_idx = np.tile(np.repeat(np.arange(C), context_list.shape[2]), P)
            ctx_keep[p_idx, c_idx,
                     np.asarray(context_list, np.int64).ravel()] = True
        oi = np.zeros((P, 1, R), bool)
        oj = np.zeros((P, 1, R), bool)
        oi[np.arange(P), 0, np.asarray(region_pair_list)[:, 0]] = True
        oj[np.arange(P), 0, np.asarray(region_pair_list)[:, 1]] = True
        rows = np.stack([ctx_keep | oi | oj, ctx_keep | oi,
                         ctx_keep | oj, ctx_keep], axis=2)   # (P, C, 4, R)
        return rows.reshape(P * C, 4, R)

    @torch.inference_mode()
    def logits_for_pairs(self, data, region_id, region_pair_list,
                         context_list) -> np.ndarray:
        """(num_pairs, 4*num_context, num_class) float32 numpy logits.

        data: (N, 3) array or tensor; region_id: (N,) ints;
        context_list: (num_pairs, num_context, m) region indices.
        """
        num_pairs, num_context = context_list.shape[0], context_list.shape[1]
        with record_function("iq_engine.keep"):
            data = self._tensor(data, torch.float32)
            region_id = self._tensor(region_id, torch.int64)
            keep_all = torch.from_numpy(self._keep_rows_np(
                region_pair_list, context_list)).to(self.device)  # one upload
            center = data.mean(dim=0)
        bs = self.batch_contexts
        logits = []
        for s in range(0, keep_all.shape[0], bs):
            with record_function("iq_engine.mask"):
                batch = masked_interaction_batch(data, center,
                                                 keep_all[s:s + bs], region_id)
            logits.append(self.forward_fn(batch))
        with record_function("iq_engine.to_host"):
            return torch.cat(logits).cpu().numpy().reshape(
                num_pairs, 4 * num_context, -1)


def run_interaction_logits(cfg: ExperimentConfig, mode_name: str = "rotate",
                           synthetic: bool = False,
                           allow_random_init: bool = False,
                           ratios: Sequence[float] = tuple(RATIOS),
                           sample_indices: Optional[list] = None,
                           gen_pair_seed: Optional[int] = None,
                           resume: bool = False,
                           coalition_devices: Optional[Sequence] = None,
                           trace_dir: Optional[str] = None):
    """Save ratio<r>_all_logits.pt for the normal pose, the adv pose, and
    the rank-1 single region at the normal pose (reference
    final_point_binary_interaction_logits.py:83-136).

    ``gen_pair_seed`` selects which interaction_seed<k>/ tree to read and
    write (the seed gen_pair ran with) without touching this run's own
    randomness; default = cfg.seed.  ``resume`` skips (pose, ratio) outputs
    that exist and appends to the log; otherwise the log is rewritten.
    ``coalition_devices`` splits the 4-row batches over those devices
    (``pipeline.split_forward``).  ``trace_dir`` writes a ``torch.profiler``
    trace of each cloud's logits there (``utils.profiling.device_trace``)."""
    set_random(cfg.seed)
    folder_seed = cfg.seed if gen_pair_seed is None else gen_pair_seed
    mode = MODES[mode_name]
    dataset, names = resolve_dataset(cfg, synthetic)
    _, forward, device = load_frozen_model(cfg, allow_random_init)
    split, split_device = split_forward(forward, device, coalition_devices)
    engine = InteractionEngine(split, cfg.num_regions,
                               batch_contexts=cfg.interaction_batch_size,
                               device=split_device)

    indices = (sample_indices if sample_indices is not None
               else selected_sample_indices(cfg.dataset))
    for pc_idx in indices:
        data, _ = dataset[pc_idx]
        name = names[pc_idx]
        base_folder = cfg.exp_folder + f"{name}/"
        inter_folder = base_folder + f"interaction_seed{folder_seed}/"
        region_id = np.load(base_folder + "region_id.npy")
        params = np.load(inter_folder + f"{mode_name}_adv/transform_params.npy"
                         ).astype(np.float32)
        with torch.inference_mode():
            data_disturb = mode.disturb_fn(torch.from_numpy(data).to(device),
                                           torch.from_numpy(params).to(device))
        with IOStream(inter_folder + "log.txt", "a" if resume else "w") as io, \
                device_trace(trace_dir, f"interaction_logits_{name}"):
            _interaction_logits_one(engine, io, data, data_disturb, region_id,
                                    name, inter_folder, mode_name, ratios,
                                    resume)


def _interaction_logits_one(engine, io, data, data_disturb, region_id, name,
                            inter_folder, mode_name, ratios, resume):
    def save_all_orders(cloud, save_path):
        pair_list = np.load(save_path + "../region_pair_list.npy")
        if pair_list.size == 0:   # region with no ball-query neighbours
            io.cprint(f"  {save_path}: no pairs, skipping")
            return 0
        rows = 0
        for ratio in ratios:
            t0 = time.time()
            out_path = save_path + "ratio%d_all_logits.pt" % int(ratio * 100)
            if resume and os.path.exists(out_path):
                io.cprint(f"  ratio {ratio:.2f}: exists, skipping (--resume)")
                continue
            ctx = np.load(save_path
                          + "../ratio%d_context_list.npy" % int(ratio * 100))
            logits = engine.logits_for_pairs(cloud, region_id, pair_list, ctx)
            save_torch_tensor(out_path, logits)
            rows += logits.shape[0] * logits.shape[1]
            io.cprint(f"  ratio {ratio:.2f}: {logits.shape} "
                      f"in {time.time() - t0:.2f}s")
        return rows

    single_region_folder = inter_folder + f"{mode_name}_adv_single_region/"
    io.cprint(f"[interaction_logits] ======= sample {name} =======")
    # one timer over all three pose states; items = masked forwards
    with StageTimer(f"interaction:{name}", printer=io.cprint) as timer:
        forwards = save_all_orders(data, inter_folder + "normal/")
        forwards += save_all_orders(data_disturb,
                                    inter_folder + f"{mode_name}_adv/")
        for rf in sorted(os.listdir(single_region_folder)):
            region_folder = single_region_folder + rf + "/"
            if not os.path.isdir(region_folder) or int(rf[10:12]) != 1:
                continue                   # the rank-1 region only
            forwards += save_all_orders(data, region_folder + "normal/")
        # a fully resumed rerun computes nothing: no items, so the line
        # carries no rate rather than a rate of 0
        timer.items = forwards or None


# ---------------------------------------------------------------------------
# stage 3: interaction scores (host post-processing)
# ---------------------------------------------------------------------------
def compute_order_interaction(all_logits: np.ndarray, label: int,
                              softmax_type: str = "modified") -> np.ndarray:
    """I = v(S∪{i,j}) + v(S) − v(S∪{i}) − v(S∪{j}) per (pair, context).

    Args:
      all_logits: (num_pairs, 4*num_context, num_class).
    Returns:
      (num_pairs, num_context) float64.
    """
    num_pairs, rows, _ = all_logits.shape
    v = reward_from_logits_np(np.asarray(all_logits).reshape(
        num_pairs * rows, -1), label, softmax_type)
    v = v.reshape(num_pairs, rows // 4, 4)
    return v[:, :, 0] + v[:, :, 3] - v[:, :, 1] - v[:, :, 2]


def run_cal_interactions(cfg: ExperimentConfig, mode_name: str = "rotate",
                         synthetic: bool = False,
                         output_type: str = "pred",
                         ratios: Sequence[float] = tuple(RATIOS),
                         sample_indices: Optional[list] = None,
                         gen_pair_seed: Optional[int] = None):
    """Score saved logits into ratio<r>_{gt,pred}_interaction.npy
    (reference final_cal_interactions.py:40-100), on the host only: it
    never initialises CUDA.  ``gen_pair_seed`` selects the
    interaction_seed<k>/ tree; default = cfg.seed."""
    folder_seed = cfg.seed if gen_pair_seed is None else gen_pair_seed
    dataset, names = resolve_dataset(cfg, synthetic)
    indices = (sample_indices if sample_indices is not None
               else selected_sample_indices(cfg.dataset))

    def cal_all_orders(label, save_path):
        for ratio in ratios:
            path = save_path + "ratio%d_all_logits.pt" % int(ratio * 100)
            if not os.path.exists(path):
                # a region with no ball-query neighbours has no pairs, and
                # the logits stage skipped it
                print(f"  {path}: missing (no pairs), skipping")
                continue
            inter = compute_order_interaction(load_torch_tensor(path), label,
                                              cfg.softmax_type)
            save_npy(save_path + "ratio%d_%s_interaction.npy"
                     % (int(ratio * 100), output_type), inter)

    for pc_idx in indices:
        _, lbl = dataset[pc_idx]
        name = names[pc_idx]
        inter_folder = (cfg.exp_folder + f"{name}/"
                        + f"interaction_seed{folder_seed}/")
        single_region_folder = inter_folder + f"{mode_name}_adv_single_region/"

        print(f"[cal_interactions] ======= sample {name} =======")
        cal_all_orders(lbl, inter_folder + "normal/")
        pred_class = int(np.load(inter_folder
                                 + f"{mode_name}_adv/pred_labels.npy")[1])
        cal_all_orders(lbl if output_type == "gt" else pred_class,
                       inter_folder + f"{mode_name}_adv/")
        for rf in sorted(os.listdir(single_region_folder)):
            region_folder = single_region_folder + rf + "/"
            if os.path.isdir(region_folder) and int(rf[10:12]) == 1:
                cal_all_orders(lbl, region_folder + "normal/")
