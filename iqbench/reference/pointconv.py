"""PointConv (Wu, Qi and Fuxin, arXiv:1811.07246, 2019), the
density-weighted single-scale classifier of the published code
(``PointConvDensityClsSsg``), in plain PyTorch as its equations read.

Each set-abstraction level takes ``npoint`` centres by farthest-point
sampling and the ``nsample`` nearest points of each centre.  The cloud's
inverse density is that of a Gaussian KDE of bandwidth h over the whole
cloud, density_i = mean_j exp(-d_ij / 2 h^2) / (2.5 h), with d_ij the
published ``square_distance``; a group's inverse densities over their
group maximum go through DensityNet (1 -> 16 -> 8 -> 1).  The MLP (1x1 conv
+ BN + ReLU) runs on [xyz - centre, features] and is scaled by DensityNet's
output; WeightNet (3 -> 8 -> 8 -> 16) runs on the offsets; the two are
contracted over the neighbours, (K x C)^T (K x 16) -> C x 16, flattened
C-major, then Linear(16 C -> C), BatchNorm1d and ReLU.  The last level
groups the whole cloud about its mean the same way.  The head is Linear +
BN + ReLU + Dropout twice, then Linear.

Departures from the published code, each the port's too:
  * FPS starts at index 0, ties to the lowest index (``pointnet2.fps``;
    the published code draws its first centre at random);
  * DensityNet's last layer ends in a ReLU: the published code means a
    sigmoid there, but its branch is dead code (``if i ==
    len(self.mlp_convs)`` inside a loop that stops at len - 1);
  * the kNN keeps ties to the lowest index (the published ``torch.topk``
    promises no order).  Its distance is the published expression,
    (|c|^2 - 2 c.p) + |p|^2 in f32, with the dot product and both norms
    each one fmaf chain over x, y, z, as kernel 6 computes them: a point at
    a near-tie with the K-th neighbour is in or out by how that one f32
    expression rounds, so the reference states it exactly, as the
    PointNet++ reference states its ball test (``pointnet2._fma_chain``).
The KDE's distances are the published ``square_distance``, a product,
which TF32 rounds in the control.

``forward`` is the eval forward; ``plan`` gives each level's FPS and kNN
indices and the inverse densities (the enumeration computes them once per
chunk of masked clouds, before the poses move them), else they are
computed here.

Beside the model, what the benchmark's shared code asks of a family
(found by the configuration's ``reference`` file, never by name):
``leaves`` (the seeded state dict's layout), ``extra_counts`` (the kNN
groups' counts of a batch of masked clouds) and ``flops`` (the products a
batch of the window's forwards needs, for ``mfu.attrib``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import bn_eval, distinct_per_row, first_mask, gather, sq_dist
from .pointnet2 import _fma_chain, fps

LEVELS = ("sa1", "sa2")
BLOCK = 50          # clouds per block of extra_counts' kNN


def knn_distance(centres: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, N) f32 (|c|^2 - 2 c.p) + |p|^2 of centres (B, S, 3) and
    points (B, N, 3), each step rounded to f32 as kernel 6 rounds it."""
    cc = _fma_chain(centres, centres)[:, :, None]
    pp = _fma_chain(xyz, xyz)[:, None, :]
    cp = _fma_chain(centres[:, :, None, :], xyz[:, None, :, :])
    return ((cc - 2.0 * cp).float().double() + pp).float()


def knn(k: int, xyz: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """(B, S, k) indices of each centre's k nearest points, ascending
    distance, ties to the lowest index."""
    d = knn_distance(centres, xyz)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def inverse_density(xyz: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """(B, N) 1 / the Gaussian KDE density of each point of xyz (B, N, 3)."""
    g = torch.exp(-sq_dist(xyz, xyz) / (2.0 * bandwidth * bandwidth))
    return 1.0 / (g / (2.5 * bandwidth)).mean(dim=-1)


def _stack(h: torch.Tensor, state, prefix: str, n: int) -> torch.Tensor:
    """n layers of 1x1 conv + eval BN + ReLU, ``<prefix>.mlp_convs.j`` and
    ``<prefix>.mlp_bns.j``."""
    for j in range(n):
        w = state[f"{prefix}.mlp_convs.{j}.weight"]
        h = h @ w.reshape(w.shape[0], -1).T + state[f"{prefix}.mlp_convs.{j}.bias"]
        h = torch.relu(bn_eval(h, state, f"{prefix}.mlp_bns.{j}"))
    return h


def _conv(state, cfg, level: str, offsets, grouped, density):
    """The PointConv of groups (..., K, *): offsets (..., K, 3), the MLP's
    input ``grouped`` and the inverse densities (..., K); -> (..., C)."""
    h = _stack(grouped, state, level, len(cfg[level]["mlp"]))
    scale = density / density.amax(dim=-1, keepdim=True)
    h = h * _stack(scale[..., None], state, f"{level}.densitynet",
                   len(cfg["densitynet"]))
    wt = _stack(offsets, state, f"{level}.weightnet", len(cfg["weightnet"]))
    out = (h.transpose(-1, -2) @ wt).flatten(-2)                # C-major
    out = out @ state[f"{level}.linear.weight"].T + state[f"{level}.linear.bias"]
    return torch.relu(bn_eval(out, state, f"{level}.bn_linear"))


def level_plan(spec, xyz: torch.Tensor):
    """An SA level's (FPS indices, kNN indices, the gathered inverse
    densities, their group maximum) of clouds xyz (B, N, 3)."""
    inv = inverse_density(xyz, spec["bandwidth"])
    fps_idx = fps(xyz, spec["npoint"])
    idx = knn(spec["nsample"], xyz, gather(xyz, fps_idx))
    den = gather(inv[..., None], idx)[..., 0]
    return fps_idx, idx, den, den.amax(dim=-1, keepdim=True)


def set_abstraction(state, cfg, level: str, xyz, points, plan=None):
    fps_idx, idx, den, _ = plan if plan is not None else level_plan(cfg[level], xyz)
    new_xyz = gather(xyz, fps_idx)
    offsets = gather(xyz, idx) - new_xyz[:, :, None, :]
    grouped = offsets if points is None else torch.cat(
        [offsets, gather(points, idx)], dim=-1)
    return new_xyz, _conv(state, cfg, level, offsets, grouped, den)


def group_all(state, cfg, xyz, points, inv: Optional[torch.Tensor] = None):
    """The last level: the whole cloud (B, N, 3) about its mean -> (B, C)."""
    if inv is None:
        inv = inverse_density(xyz, cfg["sa3"]["bandwidth"])
    offsets = xyz - xyz.mean(dim=1, keepdim=True)
    return _conv(state, cfg, "sa3", offsets, torch.cat([offsets, points], -1), inv)


def forward(state, cfg, x: torch.Tensor, plan=None) -> torch.Tensor:
    """Eval logits (B, classes) of clouds x (B, N, 3)."""
    levels, inv3 = plan if plan is not None else ((None, None), None)
    l1_xyz, l1 = set_abstraction(state, cfg, "sa1", x, None, levels[0])
    l2_xyz, l2 = set_abstraction(state, cfg, "sa2", l1_xyz, l1, levels[1])
    h = group_all(state, cfg, l2_xyz, l2, inv3)
    for i in range(1, len(cfg["fc_widths"]) + 1):
        h = torch.relu(bn_eval(h @ state[f"fc{i}.weight"].T
                               + state[f"fc{i}.bias"], state, f"bn{i}"))
    i = len(cfg["fc_widths"]) + 1
    return h @ state[f"fc{i}.weight"].T + state[f"fc{i}.bias"]


def plan(cfg, x: torch.Tensor):
    """Per SA level (FPS indices, kNN indices, the gathered inverse
    densities, their group maximum), and the last level's inverse density,
    of clouds x, as the enumeration's plan."""
    levels, xyz = [], x
    for level in LEVELS:
        levels.append(level_plan(cfg[level], xyz))
        xyz = gather(xyz, levels[-1][0])
    return tuple(levels), inverse_density(xyz, cfg["sa3"]["bandwidth"])


def _stack_leaves(prefix: str, c_in: int, widths):
    out = []
    for j, f in enumerate(widths):
        out += [([f"{prefix}.mlp_convs.{j}.weight"], (f, c_in, 1, 1), "w"),
                ([f"{prefix}.mlp_convs.{j}.bias"], (f,), "b", c_in),
                ([f"{prefix}.mlp_bns.{j}"], f, "bn")]
        c_in = f
    return out


def leaves(cfg):
    """(names sharing one tensor, shape or width, kind[, fan_in]) of the
    state dict, kind ``w`` a product, ``b`` a bias, ``bn`` a BatchNorm."""
    out, feat = [], 0
    for level in LEVELS + ("sa3",):
        mlp = cfg[level]["mlp"]
        c, wo = mlp[-1], cfg["weightnet"][-1]
        out += _stack_leaves(level, 3 + feat, mlp)
        out += _stack_leaves(f"{level}.weightnet", 3, cfg["weightnet"])
        out += [([f"{level}.linear.weight"], (c, wo * c), "w"),
                ([f"{level}.linear.bias"], (c,), "b", wo * c),
                ([f"{level}.bn_linear"], c, "bn")]
        out += _stack_leaves(f"{level}.densitynet", 1, cfg["densitynet"])
        feat = c
    c_in = feat
    for i, f in enumerate(cfg["fc_widths"] + [cfg["num_classes"]], 1):
        out += [([f"fc{i}.weight"], (f, c_in), "w"),
                ([f"fc{i}.bias"], (f,), "b", c_in)]
        if i <= len(cfg["fc_widths"]):
            out.append(([f"bn{i}"], f, "bn"))
        c_in = f
    return out


def group_counts(cfg, x: torch.Tensor, ident: torch.Tensor) -> dict:
    """Per SA level of clouds x (M, N, 3) whose points have the identities
    ``ident`` (M, N) (equal identity, equal point): the distinct centres
    and their square, the distinct database rows and their square, the
    distinct centres times the distinct rows (each summed over the clouds),
    and the distinct points among each distinct centre's ``nsample``
    nearest, summed, found with this module's FPS and kNN on the clouds as
    they are (the plan's groups; translation keeps distances)."""
    absent = int(ident.max()) + 1
    out = {}
    for level in LEVELS:
        spec = cfg[level]
        idx = fps(x, spec["npoint"])
        cx, ci = gather(x, idx), ident.gather(1, idx)
        centre = first_mask(ci)                             # distinct centres
        c = centre.sum(-1).double()
        db = distinct_per_row(ident, absent).double()
        slots = 0
        for s in range(0, x.shape[0], BLOCK):
            nb = knn(spec["nsample"], x[s:s + BLOCK], cx[s:s + BLOCK])
            ids = ident[s:s + BLOCK].gather(
                1, nb.reshape(nb.shape[0], -1)).reshape(nb.shape)
            slots += int((distinct_per_row(ids, absent)
                          * centre[s:s + BLOCK]).sum())
        out[level] = {"centres": int(c.sum()), "centres_sq": int((c * c).sum()),
                      "db": int(db.sum()), "db_sq": int((db * db).sum()),
                      "centres_db": int((c * db).sum()), "slots": slots}
        x, ident = cx, ci
    return out


def extra_counts(cfg, masked: torch.Tensor, ident: torch.Tensor) -> dict:
    """What ``flops`` and kernel 7's readers read beyond the distinct
    points: ``groups`` (``group_counts``)."""
    return {"groups": group_counts(cfg, masked, ident)}


def net_macs(widths, c_in: int) -> int:
    """Multiply-adds of a pointwise stack of ``widths`` from ``c_in``."""
    macs = 0
    for f in widths:
        macs += c_in * f
        c_in = f
    return macs


def flops(cfg, e) -> float:
    """Operations (2 a multiply-add) of a work entry ``e`` (``clouds``,
    ``forwards``, ``plans``, ``groups``).  Per SA level and forward: layer 1
    hoisted, (3 + features) C1 a distinct database row and 3 C1 a distinct
    centre; per distinct slot of a distinct centre the MLP's other layers,
    DensityNet, WeightNet and the contraction, 16 C3; the Linear layer, 16
    C3 C3 a distinct centre.  The last level the same on each distinct
    second-level centre, its Linear layer once a cloud; the head.  Per
    plan: the KDE's distances between distinct points of each level's
    cloud and the kNN's from distinct centres to distinct rows, 3 each.
    FPS (no product) is not counted."""
    g, wo = e["groups"], cfg["weightnet"][-1]
    side = net_macs(cfg["densitynet"], 1) + net_macs(cfg["weightnet"], 3)
    macs, feat = 0.0, 0
    for level in LEVELS:
        counts, mlp = g[level], cfg[level]["mlp"]
        macs += (counts["db"] * (3 + feat) * mlp[0] + counts["centres"] * 3 * mlp[0])
        macs += counts["slots"] * (net_macs(mlp[1:], mlp[0]) + side + wo * mlp[-1])
        macs += counts["centres"] * wo * mlp[-1] * mlp[-1]
        feat = mlp[-1]
    mlp = cfg["sa3"]["mlp"]
    macs += g["sa2"]["centres"] * (net_macs(mlp, 3 + feat) + side + wo * mlp[-1])
    macs += e["clouds"] * wo * mlp[-1] * mlp[-1]
    macs += e["clouds"] * net_macs(cfg["fc_widths"] + [cfg["num_classes"]], mlp[-1])
    dist = sum(g[level]["db_sq"] + g[level]["centres_db"] for level in LEVELS)
    dist += g["sa2"]["centres_sq"]
    return 2.0 * (e["forwards"] * macs + e["plans"] * 3 * dist)
