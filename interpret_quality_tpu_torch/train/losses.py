"""Classification losses (counterpart of
``interpret_quality_tpu/train/losses.py``; reference
tools/final_util.py:71-88)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from ..parallel import data_parallel

SMOOTHING_EPS = 0.2


def _weighted_mean(per_sample: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over rows; with ``weights`` (a padded tail's validity mask), the
    weighted mean, so the pad rows carry no gradient.  Under a
    data-parallel context the weighted mean is this rank's share of the
    global batch's: its rows' sum over the all-reduced sum of the
    weights."""
    if weights is None:
        return per_sample.mean()
    w = weights.to(per_sample.dtype)
    dp = data_parallel.active()
    total = w.sum() if dp is None else dp.all_reduce(w.sum())
    return (per_sample * w).sum() / total.clamp(min=1.0)


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         eps: float = SMOOTHING_EPS,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed cross entropy: target one_hot * (1 - eps) +
    (1 - one_hot) * eps / (C - 1)."""
    n_class = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
    target = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    log_prb = F.log_softmax(logits, dim=-1)
    return _weighted_mean(-(target * log_prb).sum(dim=-1), weights)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    log_prb = F.log_softmax(logits, dim=-1)
    picked = log_prb.gather(-1, labels.long()[:, None])[:, 0]
    return _weighted_mean(-picked, weights)


def cal_loss(logits: torch.Tensor, labels: torch.Tensor,
             smoothing: bool = True,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    if smoothing:
        return smooth_cross_entropy(logits, labels, weights=weights)
    return cross_entropy(logits, labels, weights=weights)
