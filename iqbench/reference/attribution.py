"""Masked coalitions, the reward and the marginals of region Shapley values
and pairwise interactions (the published pipeline's definitions), and the
blocked evaluation of a reference model over them."""
from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from .common import blocked


def model(cfg):
    """The reference module of a configuration, the file its ``reference``
    names in this package (``forward``, ``plan``, ``leaves``, ``flops`` and,
    where a family counts more than distinct points, ``extra_counts``)."""
    name = os.path.splitext(os.path.basename(cfg["reference"]))[0]
    return importlib.import_module(f"{__package__}.{name}")


def keep_matrix(orders: np.ndarray) -> np.ndarray:
    """(O, R+1, R) bool: row r of order o keeps the regions at positions
    below r of the order."""
    pos = np.argsort(orders, axis=1)
    return pos[:, None, :] < np.arange(orders.shape[1] + 1)[None, :, None]


def mask(data: torch.Tensor, keep: torch.Tensor,
         region_id: torch.Tensor) -> torch.Tensor:
    """Clouds (rows of keep, N, 3): the kept regions' points as they are,
    the others collapsed onto the cloud's centre."""
    keep = keep.reshape(-1, keep.shape[-1])[:, region_id]       # (M, N)
    return torch.where(keep[..., None], data, data.mean(dim=0))


def interaction_keep(pairs: np.ndarray, ctx: np.ndarray,
                     num_regions: int) -> np.ndarray:
    """(P, C, 4, R) bool: per pair (i, j) and context S the rows
    S u {i, j}, S u {i}, S u {j}, S."""
    P, C, _ = ctx.shape
    s = np.zeros((P, C, num_regions), bool)
    np.put_along_axis(s, ctx.astype(np.int64), True, axis=-1)
    oi = np.zeros((P, 1, num_regions), bool)
    oj = np.zeros((P, 1, num_regions), bool)
    oi[np.arange(P), 0, pairs[:, 0]] = True
    oj[np.arange(P), 0, pairs[:, 1]] = True
    return np.stack([s | oi | oj, s | oi, s | oj, s], axis=2)


def reward(logits: torch.Tensor, label: int) -> torch.Tensor:
    """log p / (1 - p) of the label: its logit less the logsumexp of the
    others."""
    others = torch.cat([logits[:, :label], logits[:, label + 1:]], dim=1)
    return logits[:, label] - torch.logsumexp(others, dim=1)


def shapley(logits: torch.Tensor, orders: np.ndarray, label: int,
            dtype=torch.float64) -> np.ndarray:
    """(R,) float64: each region's marginal v(before + it) - v(before)
    averaged over the orders; logits in (order, row) order.  The reward and
    the marginals are computed in ``dtype`` (bfloat16 for the control: the
    precision below the engine's float32), their mean in float64."""
    O, R = orders.shape
    v = reward(torch.as_tensor(logits).to(dtype), label).reshape(O, R + 1)
    dv = (v[:, 1:] - v[:, :-1]).double().cpu().numpy()
    sv = np.zeros(R)
    np.add.at(sv, orders, dv)
    return sv / O


def logits(cfg, state, clouds: torch.Tensor, shift=None, block: int = 50):
    """The reference's eval logits of clouds (M, N, 3), ``block`` clouds at
    a time.  With ``shift`` (the enumeration's translation), the plan is
    made from the clouds as they are and the forward runs on the clouds
    moved by ``shift``, as the enumeration reuses one plan for every pose."""
    ref = model(cfg)

    def one(x):
        if shift is None:
            return ref.forward(state, cfg, x)
        return ref.forward(state, cfg, x + shift, ref.plan(cfg, x))
    return blocked(one, clouds, block)
