"""Glue: frozen-model loading, engine construction, dataset resolution
(counterpart of ``interpret_quality_tpu/pipeline.py``)."""
from __future__ import annotations

import copy
import os
from typing import Optional, Sequence

import torch

from .attrib.shapley import ShapleyEngine
from .config import ExperimentConfig
from .data.datasets import (SyntheticClouds, get_folder_name_list,
                            make_eval_dataset)
from .models import build_model, make_forward_fn
from .models.checkpoint import load_checkpoint
from .models.common import resolve_device
from .parallel import coalition_split


def load_frozen_model(cfg: ExperimentConfig, allow_random_init: bool = False):
    """Build the model on ``cfg.device`` and load its frozen eval weights.

    Reads a reference-layout ``.t7/.pth/.pt`` state dict or a flax
    ``.msgpack`` file of the JAX package (``models/checkpoint.py``), loaded
    with ``strict=True``.  The default adv-GCNN checkpoint is named by its
    final epoch (``model_399``, reference final_util.py:52-66); where it is
    absent and no ``model_path`` was given, the same run's ``model_best``
    stands in, as in the JAX package.  An explicit ``model_path`` that does
    not exist raises.  With ``allow_random_init`` a missing checkpoint falls
    back to a seeded random init with every bias nudged by +0.1 (BatchNorm
    biases included: the shift survives normalisation), as the JAX package
    does for smoke runs.  Returns (model, forward_fn, device).
    """
    device = resolve_device(cfg.device)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg.model, cfg.num_classes, cfg.k)
    path = cfg.model_path or cfg.default_model_path()
    if (cfg.model_path is None and not os.path.exists(path)
            and os.path.basename(path) == "model_399.t7"):
        best = os.path.join(os.path.dirname(path), "model_best.t7")
        if os.path.exists(best):
            print(f"[load_frozen_model] {os.path.basename(path)} absent; "
                  f"substituting best checkpoint {best}")
            path = best
    if os.path.exists(path):
        model.load_state_dict(load_checkpoint(cfg.model, path), strict=True)
    elif allow_random_init:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.add_(0.1)
    else:
        raise FileNotFoundError(
            f"checkpoint {path} not found (pass --allow_random_init to smoke-run)")
    model = model.to(device).eval()
    return model, make_forward_fn(model), device


def split_forward(forward, device, coalition_devices: Optional[Sequence] = None):
    """(forward, device) of the engines: the frozen model's ``forward`` on
    ``device`` as it is, or, given ``coalition_devices``
    (``parallel.make_mesh``), its coalition split over them, one replica of
    the model per device, the logits on the first."""
    if not coalition_devices:
        return forward, device
    model = forward.model
    split = coalition_split(
        lambda d: make_forward_fn(copy.deepcopy(model).to(d)),
        coalition_devices)
    return split, split.device


def make_engine(cfg: ExperimentConfig, forward, device,
                coalition_devices: Optional[Sequence] = None) -> ShapleyEngine:
    """The Shapley engine of ``forward``, split over ``coalition_devices``
    where given (``split_forward``)."""
    forward, device = split_forward(forward, device, coalition_devices)
    return ShapleyEngine(forward, num_regions=cfg.num_regions,
                         softmax_type=cfg.softmax_type,
                         batch_orders=min(cfg.shapley_batch_size,
                                          cfg.num_samples_save),
                         device=device)


def resolve_dataset(cfg: ExperimentConfig, synthetic: bool = False):
    """Return (dataset, folder_name_list) for the 30-sample eval set."""
    if synthetic:
        ds = SyntheticClouds(num_samples=30, num_points=cfg.num_points,
                             num_classes=cfg.num_classes, seed=cfg.seed)
        names = [f"synthetic_{i:02d}" for i in range(len(ds))]
        return ds, names
    ds = make_eval_dataset(cfg.dataset, cfg.data_root, cfg.num_points)
    return ds, get_folder_name_list(cfg.dataset)
