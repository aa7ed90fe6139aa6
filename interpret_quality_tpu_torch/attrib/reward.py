"""Reward (value function) for Shapley and interaction estimation (counterpart of
``interpret_quality_tpu/attrib/reward.py``; reference
tools/final_common.py:11-24):

  * "normal":   v = log_softmax(logits)[label]
  * "modified": v = logits[label] - logsumexp(logits[others])
                (= log p/(1-p), the log-odds of the labelled class)
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import logsumexp as np_logsumexp


def reward_from_logits(logits: torch.Tensor, label: int,
                       softmax_type: str = "modified") -> torch.Tensor:
    """Score a batch of logits (B', num_class) w.r.t. one label -> (B',)."""
    label = int(label)
    picked = logits[:, label]
    if softmax_type == "normal":
        return picked - torch.logsumexp(logits, dim=-1)
    if softmax_type == "modified":
        # mask out the labelled class with -inf before the logsumexp
        is_label = torch.arange(logits.shape[-1], device=logits.device) == label
        others = logits.masked_fill(is_label, float("-inf"))
        return picked - torch.logsumexp(others, dim=-1)
    raise ValueError(f"unknown softmax_type {softmax_type!r}")


def reward_from_logits_np(logits, label: int,
                          softmax_type: str = "modified") -> np.ndarray:
    """Numpy twin of ``reward_from_logits`` in float64, for host-side
    post-processing of saved logits, which must not initialise CUDA."""
    logits = np.asarray(logits, dtype=np.float64)
    picked = logits[:, int(label)]
    if softmax_type == "normal":
        return picked - np_logsumexp(logits, axis=-1)
    if softmax_type == "modified":
        others = np.delete(logits, int(label), axis=1)
        return picked - np_logsumexp(others, axis=-1)
    raise ValueError(f"unknown softmax_type {softmax_type!r}")
