"""Smoothness (linearity / planarity / scattering) enumeration (counterpart
of ``interpret_quality_tpu/attrib/smoothness.py``).

Reference: final_smoothness_center_enum_all.py — per region, constrained
gradient ascent/descent on the region's points to increase/decrease a
PCA-shape statistic, with variance bounds (±0.003 on each principal
orientation), a per-point displacement bound (0.03), and three stop
conditions; after each enumeration epoch the full cloud's Shapley values
are recomputed.

The objective is differentiated with ``torch.autograd.grad`` on a fresh
leaf of the cloud; the variance-bound "detach" is
``where(in_bound, v, v.detach())``.  Autograd needs grad mode: the Shapley
engine runs under ``torch.inference_mode``, so every tensor differentiated
here is made outside it.  One epoch marches all regions together in a
Python loop over device tensors, one host sync per iteration for its
condition.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..pipeline import load_frozen_model, make_engine, resolve_dataset
from ..utils.io import IOStream, mkdir, save_npy, save_torch_tensor
from ..utils.profiling import StageTimer
from ..utils.rng import set_random

STEP = 1e-3
ENUM_STEP = 0.05
EPOCH = 50
VAR_THRESHOLD = 0.003
DIST_THRESHOLD = 0.03
STOP_RATIO = 0.5
MAX_ITERATION = 100

SMOOTH_MODES = ("linearity", "planarity", "scattering")


# ---------------------------------------------------------------------------
# PCA helpers (host, 3x3 eigendecompositions)
# ---------------------------------------------------------------------------
def principal_orientations(points: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(o1, o2, o3) eigenvectors of the unbiased covariance, by descending
    eigenvalue (reference :22-45).  A region of fewer than 2 points (toy
    scales only) or with a non-finite covariance gets the canonical axes."""
    axes = (np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]))
    if points.shape[0] < 2:
        return axes
    centred = points - points.mean(axis=0)
    cov = centred.T @ centred / (points.shape[0] - 1)
    if not np.all(np.isfinite(cov)):
        return axes
    _, vecs = np.linalg.eigh(cov)            # ascending eigenvalues
    return vecs[:, 2].copy(), vecs[:, 1].copy(), vecs[:, 0].copy()


def region_smoothness_np(points: np.ndarray, mode: str) -> float:
    """Host smoothness of one region's points."""
    if points.shape[0] < 2:
        return 0.0
    o1, o2, o3 = principal_orientations(points)
    v = np.sort(np.array([np.var(points @ o, ddof=1) for o in (o1, o2, o3)]))
    if not np.isfinite(v[2]) or v[2] <= 0.0:
        return 0.0
    if mode == "linearity":
        return float((v[2] - v[1]) / v[2])
    if mode == "planarity":
        return float((v[1] - v[0]) / v[2])
    return float(v[0] / v[2])


def _smoothness_of_sorted(vs: torch.Tensor, mode: str) -> torch.Tensor:
    """Smoothness from ascending variances vs (..., 3)."""
    s_max = torch.where(vs[..., 2] > 0, vs[..., 2], 1.0)
    if mode == "linearity":
        return (vs[..., 2] - vs[..., 1]) / s_max
    if mode == "planarity":
        return (vs[..., 1] - vs[..., 0]) / s_max
    return vs[..., 0] / s_max                  # scattering


def _grad(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d out / d x; zero where nothing in ``out`` depends on ``x`` (every
    variance out of its bound)."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    return torch.autograd.grad(out, x)[0]


def _clip_to_ball(new: torch.Tensor, orig: torch.Tensor, moving: torch.Tensor):
    """Per-point displacement clip onto the 0.03 ball around the original,
    for the points where ``moving``; returns (clipped cloud, (N,) over).

    Deliberate divergence, as in the JAX package: the reference's
    apply_distance_bound (final_smoothness_center_enum_all.py:101-121)
    writes through a temporary view and never moves a point, so there the
    bound acts only through the exceed-count stop; here the projection is
    applied."""
    diff = new - orig
    dist = torch.linalg.norm(diff, dim=1)
    over = (dist > DIST_THRESHOLD) & moving
    clipped = orig + DIST_THRESHOLD * diff / torch.clamp(dist, min=1e-30)[:, None]
    return torch.where(over[:, None], clipped, new), over


# ---------------------------------------------------------------------------
# one constrained step on one region
# ---------------------------------------------------------------------------
def smoothness_step(data: torch.Tensor, orig: torch.Tensor, mask: torch.Tensor,
                    orientations: torch.Tensor, bounds: torch.Tensor,
                    mode: str, objective: str):
    """One constrained gradient step on the masked region of the cloud.

    Args:
      data: (N, 3) current cloud; orig: (N, 3) original cloud.
      mask: (N,) float 1.0 on the region's points.
      orientations: (3, 3) rows o1, o2, o3.
      bounds: (2, 3) rows [ub, lb] of the variance bounds per orientation.
    Returns:
      (new_data, smoothness, clip_count, all_out_of_bound), tensors.
    """
    with torch.enable_grad():
        x = data.detach().requires_grad_(True)
        proj = x @ orientations.T                        # (N, 3)
        s = mask.sum()
        mean = (proj * mask[:, None]).sum(0) / torch.clamp(s, min=1.0)
        # max(s-1, 1) is the identity for every real region (>= 2 points)
        v = ((mask[:, None] * (proj - mean) ** 2).sum(0)
             / torch.clamp(s - 1.0, min=1.0))            # (3,)
        in_bound = (v <= bounds[0]) & (v >= bounds[1])
        v_b = torch.where(in_bound, v, v.detach())
        smooth = _smoothness_of_sorted(torch.sort(v_b).values, mode)
        grad = _grad(smooth, x)
    with torch.no_grad():
        grad = grad * mask[:, None]
        norm = torch.linalg.norm(grad)
        delta = torch.where(norm > 0, STEP * grad / torch.clamp(norm, min=1e-30),
                            1e-8)
        new = data + delta if objective == "inc" else data - delta
        new = torch.where(mask[:, None] > 0, new, data)
        new, over = _clip_to_ball(new, orig, mask > 0)
    return new, smooth.detach(), over.sum(), ~in_bound.any()


# ---------------------------------------------------------------------------
# one epoch of all regions at once
# ---------------------------------------------------------------------------
def smoothness_epoch_all_regions(data, orig, masks, orientations, bounds,
                                 smooth_prev, active, targets,
                                 mode: str, objective: str):
    """One enumeration epoch for all regions at once.

    The reference updates regions one after another (:313-331), but each
    region's objective and update have support only on its own points, so
    the trajectories are independent and marching them together gives the
    sequential result (``update_region``).  The stop conditions are latched
    per region.

    Args:
      data, orig: (N, 3); masks: (R, N) float; orientations: (R, 3, 3);
      bounds: (R, 2, 3); smooth_prev: (R,); active: (R,) bool;
      targets: (R,) this epoch's target smoothness per region.
    Returns:
      (new_data, smooth (R,), keep_updating (R,) bool), tensors.
    """
    R = masks.shape[0]
    num_pts = masks.sum(1)                                 # (R,)
    sign = 1.0 if objective == "inc" else -1.0

    def not_reached(s):
        return s < targets if objective == "inc" else s > targets

    def smooth_and_grad(x, chase):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            proj = torch.einsum("nc,rdc->rnd", xg, orientations)   # (R, N, 3)
            m = masks[:, :, None]
            s = num_pts[:, None]
            mean = (proj * m).sum(1, keepdim=True) / torch.clamp(s[:, None],
                                                                 min=1.0)
            # max(s-1, 1) keeps single-point toy regions NaN-free (inactive)
            v = (m * (proj - mean) ** 2).sum(1) / torch.clamp(s - 1.0, min=1.0)
            in_bound = (v <= bounds[:, 0]) & (v >= bounds[:, 1])
            v_b = torch.where(in_bound, v, v.detach())
            sm = _smoothness_of_sorted(torch.sort(v_b, dim=1).values, mode)
            # gradients only for the regions still chasing this iteration
            sm_g = torch.where(chase, sm, sm.detach())
            grad = _grad(sm_g.sum(), xg)
        return sm.detach(), in_bound, grad                 # (R,), (R,3), (N,3)

    x, smooth, act = data, smooth_prev, active
    iters = torch.zeros(R, dtype=torch.int32, device=data.device)
    while bool((act & not_reached(smooth)).any()):         # one host sync
        chase = act & not_reached(smooth)
        sm, in_bound, grad = smooth_and_grad(x, chase)
        with torch.no_grad():
            # per-region normalised step on each region's own points
            gnorm_r = torch.sqrt(((grad[None] * masks[:, :, None]) ** 2
                                  ).sum(dim=(1, 2)))       # (R,)
            point_norm = masks.T @ gnorm_r                 # (N,) own region's
            point_chase = masks.T @ chase.float()          # (N,) 1 if chasing
            delta = torch.where(
                point_norm[:, None] > 0,
                STEP * grad / torch.clamp(point_norm, min=1e-30)[:, None], 1e-8)
            new = x + sign * delta * point_chase[:, None]
            new, over = _clip_to_ball(new, orig, point_chase > 0)
            counts = masks @ over.float()                  # (R,)
            # stop conditions (reference :169-181), latched per region
            stop = ((counts / num_pts > STOP_RATIO) | ~in_bound.any(dim=1)
                    | (iters + 1 > MAX_ITERATION))
            act = act & ~(chase & stop)
            iters = iters + chase.int()
            smooth = torch.where(chase, sm, smooth)
            x = new
    return x, smooth, act


def update_region(data_copy: np.ndarray, orig: np.ndarray, mask: np.ndarray,
                  orientations: np.ndarray, bounds: np.ndarray,
                  smoothness_prev: float, mode: str, objective: str,
                  io: Optional[IOStream] = None):
    """March one region's smoothness one ENUM_STEP further, the reference's
    sequential way, on the CPU; returns (data_copy, smoothness,
    keep_updating)."""
    target = (smoothness_prev + ENUM_STEP if objective == "inc"
              else smoothness_prev - ENUM_STEP)
    num_total = int(mask.sum())
    smoothness = smoothness_prev
    if_update = True
    iteration = 0
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    data_t, orig_t, mask_t = t(data_copy), t(orig), t(mask)
    ori_t, bounds_t = t(orientations), t(bounds)

    def not_reached(s):
        return s < target if objective == "inc" else s > target

    while not_reached(smoothness):
        data_t, smooth, count, all_oob = smoothness_step(
            data_t, orig_t, mask_t, ori_t, bounds_t, mode, objective)
        smoothness = float(smooth)
        iteration += 1
        if (float(count) / num_total > STOP_RATIO or bool(all_oob)
                or iteration > MAX_ITERATION):
            if_update = False
            break
    if io is not None:
        io.cprint("curr smoothness: %.8f" % smoothness)
    return data_t.numpy(), smoothness, if_update


def test_all_region(engine, data: np.ndarray, lbl: int, orders: np.ndarray,
                    region_id: np.ndarray, mode_folder: str,
                    cfg: ExperimentConfig, mode: str, objective: str,
                    max_epochs: int = EPOCH):
    """Enumerate smoothness for all regions; recompute Shapley per epoch
    (reference final_smoothness_center_enum_all.py:281-350).  The name is
    the reference's; it is not a test."""
    assert objective in ("inc", "dec")
    t0 = time.time()
    result_path = mode_folder + f"allregion_{objective}/"
    mkdir(result_path)
    R = cfg.num_regions
    orig = np.array(data, np.float32)
    with IOStream(result_path + "log.txt", "w") as io:
        io.cprint(str(cfg))
        orig_sv = engine.shapley_for_pose(data, lbl, region_id, orders)
        io.cprint("origin shapley of this region: %s" % str(orig_sv))
        save_npy(result_path + "orig_shapley_value.npy", orig_sv)

        masks, orients, bounds, smooth_prev, usable = [], [], [], [], []
        for r in range(R):
            m = region_id == r
            pts = orig[m]
            o1, o2, o3 = principal_orientations(pts)
            v = (np.array([np.var(pts @ o, ddof=1) for o in (o1, o2, o3)])
                 if pts.shape[0] >= 2 else np.zeros(3))
            masks.append(m.astype(np.float32))
            orients.append(np.stack([o1, o2, o3]))
            bounds.append(np.stack([v + VAR_THRESHOLD, v - VAR_THRESHOLD]))
            smooth_prev.append(region_smoothness_np(pts, mode))
            usable.append(pts.shape[0] >= 2 and np.all(np.isfinite(v)))

        def dev(a, dtype=torch.float32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=engine.device)
        data_t, orig_t = dev(orig), dev(orig)
        masks_t, orients_t = dev(np.stack(masks)), dev(np.stack(orients))
        bounds_t, smooth_t = dev(np.stack(bounds)), dev(smooth_prev)
        active_t = dev(usable, torch.bool)

        smoothness_list, data_list, sv_list, logits_list = [], [], [], []
        # items = masked forwards inside the timed region (one Shapley
        # recompute per epoch)
        with StageTimer(f"smoothness:{mode}:{objective}",
                        printer=io.cprint) as timer:
            for epoch in range(max_epochs):
                io.cprint("\n************ epoch %d ***********" % epoch)
                step = ENUM_STEP if objective == "inc" else -ENUM_STEP
                targets = torch.where(active_t, smooth_t + step, smooth_t)
                data_t, smooth_t, active_t = smoothness_epoch_all_regions(
                    data_t, orig_t, masks_t, orients_t, bounds_t, smooth_t,
                    active_t, targets, mode, objective)
                smooth_np = smooth_t.cpu().numpy()
                smoothness_list.append(smooth_np.tolist())
                data_list.append(data_t.cpu().numpy()[None])
                io.cprint("curr smoothness: %s" % str(smooth_np))

                sv, logits = engine.shapley_for_pose(
                    data_t, lbl, region_id, orders, return_logits=True)
                sv_list.append(sv)
                logits_list.append(logits)
                io.cprint("region shapley value: %s" % str(sv))
                if not bool(active_t.any()):
                    break
            timer.items = len(sv_list) * orders.shape[0] * (R + 1)

        save_npy(result_path + "region_shapley_value.npy", np.array(sv_list))
        save_torch_tensor(result_path + "all_logits.pt", np.stack(logits_list))
        save_npy(result_path + f"{mode}.npy", np.array(smoothness_list))
        save_npy(result_path + "data_smoothness.npy", np.array(data_list))
        io.cprint("time: %f" % (time.time() - t0))


def run_smoothness(cfg: ExperimentConfig, modes=SMOOTH_MODES,
                   synthetic: bool = False, allow_random_init: bool = False,
                   sample_indices: Optional[list] = None,
                   max_epochs: Optional[int] = None, resume: bool = False,
                   coalition_devices: Optional[Sequence] = None):
    """Full smoothness suite: {linearity, planarity, scattering} x {inc, dec}.

    ``resume`` skips (sample, mode, objective) cells whose final artifact
    already exists, so an interrupted suite restarts at the first
    incomplete cell.  ``coalition_devices`` splits each epoch's coalition
    batches over those devices (``pipeline.split_forward``)."""
    epochs = EPOCH if max_epochs is None else max_epochs
    set_random(cfg.seed)
    dataset, names = resolve_dataset(cfg, synthetic)
    _, forward, device = load_frozen_model(cfg, allow_random_init)
    engine = make_engine(cfg, forward, device, coalition_devices)

    indices = sample_indices if sample_indices is not None else range(len(dataset))
    for pc_index in indices:
        data, lbl = dataset[pc_index]
        base_folder = cfg.exp_folder + f"{names[pc_index]}/"
        region_id = np.load(base_folder + "region_id.npy")
        orders = np.load(base_folder + "all_orders.npy")[:cfg.num_samples]
        for mode in modes:
            mode_folder = base_folder + f"{mode}_all/"
            mkdir(mode_folder)
            for objective in ("inc", "dec"):
                done_marker = (mode_folder + f"allregion_{objective}/"
                               + "region_shapley_value.npy")
                if resume and os.path.exists(done_marker):
                    print(f"[smoothness:{mode}:{objective}] "
                          f"{names[pc_index]}: artifacts exist, skipping")
                    continue
                test_all_region(engine, data, lbl, orders, region_id,
                                mode_folder, cfg, mode, objective,
                                max_epochs=epochs)
