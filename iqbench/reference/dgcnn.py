"""DGCNN (Wang et al., ACM TOG 2019, arXiv:1801.07829) in plain PyTorch:
the classifier of the published code, computed as its equations read.

Each EdgeConv layer takes the k nearest neighbours of every point in the
layer's input space (self included, ties to the lowest index), the edge
features [x_j - x_i, x_i], a 1x1 convolution without bias, BatchNorm,
LeakyReLU(0.2) and the max over the neighbours.  The four layers' outputs
are concatenated, lifted to the embedding by conv5 + BN + LeakyReLU, pooled
by max and mean, and classified by Linear(no bias) + BN + LeakyReLU +
Dropout, Linear + BN + LeakyReLU + Dropout, Linear.

``forward`` is the eval forward; ``plan`` replaces layer 1's graph (the
enumeration builds it once per chunk of masked clouds, before the poses
move them).

Beside the model, what the benchmark's shared code asks of a family
(found by the configuration's ``reference`` file, never by name):
``leaves`` (the seeded state dict's layout) and ``flops`` (the products a
batch of the window's forwards needs, for ``mfu.attrib``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from .common import bn_eval, gather, knn

SLOPE = 0.2


def _edges(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Edge features (B, N, k, 2C) of x (B, N, C) over neighbours idx."""
    centre = x[:, :, None, :].expand(-1, -1, idx.shape[-1], -1)
    return torch.cat([gather(x, idx) - centre, centre], dim=-1)


def _layer_weight(state, i: int) -> torch.Tensor:
    w = state[f"conv{i}.0.weight"]
    return w.reshape(w.shape[0], -1)


def _head_eval(feats, state):
    h = torch.cat(feats, dim=-1)
    h = F.leaky_relu(bn_eval(h @ _layer_weight(state, 5).T, state, "bn5"), SLOPE)
    h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
    h = F.leaky_relu(bn_eval(h @ state["linear1.weight"].T, state, "bn6"), SLOPE)
    h = F.leaky_relu(bn_eval(h @ state["linear2.weight"].T + state["linear2.bias"],
                             state, "bn7"), SLOPE)
    return h @ state["linear3.weight"].T + state["linear3.bias"]


def forward(state, cfg, x: torch.Tensor,
            plan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval logits (B, classes) of clouds x (B, N, 3)."""
    k = cfg["k"]
    h, feats = x, []
    for i in range(1, len(cfg["edge_widths"]) + 1):
        idx = plan if (i == 1 and plan is not None) else knn(h, k)
        y = _edges(h, idx) @ _layer_weight(state, i).T
        h = F.leaky_relu(bn_eval(y, state, f"bn{i}"), SLOPE).amax(dim=2)
        feats.append(h)
    return _head_eval(feats, state)


def plan(cfg, x: torch.Tensor) -> torch.Tensor:
    """Layer 1's graph of clouds x, as the enumeration's plan."""
    return knn(x, cfg["k"])


def leaves(cfg):
    """(names sharing one tensor, shape or width, kind[, fan_in]) of the
    state dict, kind ``w`` a product, ``b`` a bias, ``bn`` a BatchNorm."""
    out, c_in = [], cfg["input_channels"]
    widths = cfg["edge_widths"]
    for i, f in enumerate(widths, 1):
        out.append(([f"conv{i}.0.weight"], (f, 2 * c_in, 1, 1), "w"))
        out.append(([f"bn{i}", f"conv{i}.1"], f, "bn"))
        c_in = f
    emb = cfg["emb_dims"]
    out.append((["conv5.0.weight"], (emb, sum(widths), 1), "w"))
    out.append((["bn5", "conv5.1"], emb, "bn"))
    fc1, fc2 = cfg["fc_widths"]
    out.append((["linear1.weight"], (fc1, 2 * emb), "w"))
    out.append((["bn6"], fc1, "bn"))
    out += [(["linear2.weight"], (fc2, fc1), "w"),
            (["linear2.bias"], (fc2,), "b", fc1)]
    out.append((["bn7"], fc2, "bn"))
    out += [(["linear3.weight"], (cfg["num_classes"], fc2), "w"),
            (["linear3.bias"], (cfg["num_classes"],), "b", fc2)]
    return out


def flops(cfg, e) -> float:
    """Operations (2 a multiply-add) of a work entry ``e`` (``clouds``,
    each cloud's distinct points ``d``, ``forwards``, ``plans``): each
    EdgeConv's two hoisted products per point, x W1 and x (W2 - W1), 2 C F;
    each kNN's inner products, C d^2 (layer 1's on xyz once per plan where
    a plan gives it); conv5, 512 x 1024 a point; the head, 2048 x 512 +
    512 x 256 + 256 x classes a cloud."""
    d = e["d"].astype(float)
    sd, sd2 = d.sum(), (d * d).sum()
    widths = cfg["edge_widths"]
    c_in = [cfg["input_channels"]] + widths[:-1]
    fwd = sum(2 * C * F * sd for C, F in zip(c_in, widths))
    knn_macs = [C * sd2 for C in c_in]
    fwd += sum(knn_macs[1:] if e["plans"] else knn_macs)
    fwd += sum(widths) * cfg["emb_dims"] * sd
    fc1, fc2 = cfg["fc_widths"]
    fwd += e["clouds"] * (2 * cfg["emb_dims"] * fc1 + fc1 * fc2
                          + fc2 * cfg["num_classes"])
    return 2.0 * (e["forwards"] * fwd + e["plans"] * knn_macs[0])
