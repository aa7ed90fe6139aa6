"""PointNet++ MSG (Qi et al., NeurIPS 2017, arXiv:1706.02413) classifier in
plain PyTorch, as the published code computes it.

Each multi-scale set-abstraction level takes ``npoint`` centres by
farthest-point sampling (the first point fixed at index 0, ties to the
lowest index), and per radius the first ``nsample`` points of the ball in
index order (empty slots repeat the first in-ball point).  Membership is
the published ``square_distance``, (|c|^2 - 2 c.p) + |p|^2 <= r^2, in f32
with each multiply-add of the norms and the dot rounded once (an fmaf
chain over x, y, z): a point near the sphere is in or out by how that
one f32 expression rounds, so the reference states it exactly; each branch runs its 1x1 conv + BN + ReLU stack on
[features, xyz - centre] and takes the max over the slots.  The last level
runs its stack on [xyz, features] of every point (xyz uncentred) and takes
the max.  The head is Linear + BN + ReLU + Dropout twice, then Linear.

``forward`` is the eval forward; ``plan`` gives each level's FPS indices
(the enumeration computes them once per chunk of masked clouds, before the
poses move them), else FPS runs here.

Beside the model, what the benchmark's shared code asks of a family
(found by the configuration's ``reference`` file, never by name):
``leaves`` (the seeded state dict's layout), ``extra_counts`` (the ball
counts of a batch of masked clouds) and ``flops`` (the products a batch of
the window's forwards needs, for ``mfu.attrib``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .common import bn_eval, distinct_per_row, first_mask, gather

BALL_BLOCK = 200


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, npoint) indices of xyz (B, N, 3): start at 0, then each time the
    point farthest from the chosen ones (squared distance summed x, y, z),
    ties to the lowest index."""
    B, N, _ = xyz.shape
    out = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    far = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        d = (xyz - xyz[rows, far][:, None, :]) ** 2
        dist = torch.minimum(dist, d[..., 0] + d[..., 1] + d[..., 2])
        far = torch.argmax(dist, dim=-1)
    return out


def _fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i b_i over the last axis (3), each step fmaf(a_i, b_i, acc)
    rounded once to f32: the exact f32 products and sums in float64."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      dtype=torch.float64, device=a.device)
    for i in range(a.shape[-1]):
        acc = (a[..., i].double() * b[..., i].double() + acc).float().double()
    return acc


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centres: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) indices: the first in-ball points of each centre in
    index order, the rest of the slots the first in-ball point."""
    N = xyz.shape[1]
    c, p = centres[:, :, None, :], xyz[:, None, :, :]
    d2 = ((_fma_chain(c, c) - 2.0 * _fma_chain(c, p)).float().double()
          + _fma_chain(p, p)).float()
    ar = torch.arange(N, device=xyz.device)
    idx = torch.where(d2 <= torch.tensor(radius ** 2, dtype=torch.float32), ar, N)
    idx = torch.sort(idx, dim=-1).values[..., :nsample]
    first = idx[..., :1]
    return torch.where(idx == N, torch.where(first == N, 0, first), idx)


def _stack(h: torch.Tensor, state, convs: str, bns: str, n: int) -> torch.Tensor:
    for j in range(n):
        w = state[f"{convs}.{j}.weight"]
        h = h @ w.reshape(w.shape[0], -1).T + state[f"{convs}.{j}.bias"]
        h = torch.relu(bn_eval(h, state, f"{bns}.{j}"))
    return h


def set_abstraction(state, level: str, spec, xyz: torch.Tensor,
                    points: Optional[torch.Tensor],
                    fps_idx: Optional[torch.Tensor]):
    if fps_idx is None:
        fps_idx = fps(xyz, spec["npoint"])
    new_xyz = gather(xyz, fps_idx)
    outs = []
    for b, (radius, k, mlp) in enumerate(zip(spec["radii"], spec["nsamples"],
                                             spec["mlps"])):
        idx = ball_query(radius, k, xyz, new_xyz)
        grouped = gather(xyz, idx) - new_xyz[:, :, None, :]
        if points is not None:
            grouped = torch.cat([gather(points, idx), grouped], dim=-1)
        h = _stack(grouped, state, f"{level}.conv_blocks.{b}",
                   f"{level}.bn_blocks.{b}", len(mlp))
        outs.append(h.amax(dim=2))
    return new_xyz, torch.cat(outs, dim=-1)


def forward(state, cfg, x: torch.Tensor,
            plan: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Eval logits (B, classes) of clouds x (B, N, 3)."""
    f1, f2 = plan if plan is not None else (None, None)
    l1_xyz, l1 = set_abstraction(state, "sa1", cfg["sa1"], x, None, f1)
    l2_xyz, l2 = set_abstraction(state, "sa2", cfg["sa2"], l1_xyz, l1, f2)
    h = _stack(torch.cat([l2_xyz, l2], dim=-1), state, "sa3.mlp_convs",
               "sa3.mlp_bns", len(cfg["sa3_mlp"])).amax(dim=1)
    for i in range(1, len(cfg["fc_widths"]) + 1):
        h = torch.relu(bn_eval(h @ state[f"fc{i}.weight"].T
                               + state[f"fc{i}.bias"], state, f"bn{i}"))
    i = len(cfg["fc_widths"]) + 1
    return h @ state[f"fc{i}.weight"].T + state[f"fc{i}.bias"]


def plan(cfg, x: torch.Tensor):
    """Each level's FPS indices of clouds x, as the enumeration's plan."""
    f1 = fps(x, cfg["sa1"]["npoint"])
    return f1, fps(gather(x, f1), cfg["sa2"]["npoint"])


def leaves(cfg):
    """(names sharing one tensor, shape or width, kind[, fan_in]) of the
    state dict, kind ``w`` a product, ``b`` a bias, ``bn`` a BatchNorm."""
    out, c_feat = [], 0
    for level in ("sa1", "sa2"):
        for b, mlp in enumerate(cfg[level]["mlps"]):
            c_in = c_feat + 3
            for j, f in enumerate(mlp):
                out += [([f"{level}.conv_blocks.{b}.{j}.weight"], (f, c_in, 1, 1), "w"),
                        ([f"{level}.conv_blocks.{b}.{j}.bias"], (f,), "b", c_in),
                        ([f"{level}.bn_blocks.{b}.{j}"], f, "bn")]
                c_in = f
        c_feat = sum(m[-1] for m in cfg[level]["mlps"])
    c_in = c_feat + 3
    for j, f in enumerate(cfg["sa3_mlp"]):
        out += [([f"sa3.mlp_convs.{j}.weight"], (f, c_in, 1, 1), "w"),
                ([f"sa3.mlp_convs.{j}.bias"], (f,), "b", c_in),
                ([f"sa3.mlp_bns.{j}"], f, "bn")]
        c_in = f
    for i, f in enumerate(cfg["fc_widths"] + [cfg["num_classes"]], 1):
        out += [([f"fc{i}.weight"], (f, c_in), "w"),
                ([f"fc{i}.bias"], (f,), "b", c_in)]
        if i <= len(cfg["fc_widths"]):
            out.append(([f"bn{i}"], f, "bn"))
        c_in = f
    return out


def ball_counts(cfg, x: torch.Tensor, ident: torch.Tensor) -> dict:
    """Per level of clouds x (M, N, 3) whose points have the identities
    ``ident`` (M, N) (equal identity, equal point): the distinct FPS centres,
    the distinct database rows, their product summed over clouds, and per
    branch the distinct points among each distinct centre's first
    ``nsample`` in-ball points, found with this module's FPS and ball rule
    on the clouds as they are (the plan's centres; translation keeps
    distances)."""
    absent = int(ident.max()) + 1
    out = {}
    for level in ("sa1", "sa2"):
        spec = cfg[level]
        idx = fps(x, spec["npoint"])
        cx, ci = gather(x, idx), ident.gather(1, idx)
        centre = first_mask(ci)                             # distinct centres
        db = distinct_per_row(ident, absent)
        slots = [0] * len(spec["radii"])
        for s in range(0, x.shape[0], BALL_BLOCK):
            xb, ib, cb, keep = (x[s:s + BALL_BLOCK], ident[s:s + BALL_BLOCK],
                                cx[s:s + BALL_BLOCK], centre[s:s + BALL_BLOCK])
            d2 = ((cb[:, :, None, :] - xb[:, None, :, :]) ** 2).sum(-1)
            for b, (r, k) in enumerate(zip(spec["radii"], spec["nsamples"])):
                inb = d2 <= r * r
                first_k = inb & (torch.cumsum(inb, -1) <= k)
                ids = torch.where(first_k, ib[:, None, :], absent)
                slots[b] += int((distinct_per_row(ids, absent) * keep).sum())
        out[level] = {"centres": int(centre.sum()), "db": int(db.sum()),
                      "centres_db": int((centre.sum(-1) * db).sum()),
                      "slots": slots}
        x, ident = cx, ci
    return out


def extra_counts(cfg, masked: torch.Tensor, ident: torch.Tensor) -> dict:
    """What ``flops`` and kernel 5's roofline read beyond the distinct
    points: ``balls`` (``ball_counts``)."""
    return {"balls": ball_counts(cfg, masked, ident)}


def flops(cfg, e) -> float:
    """Operations (2 a multiply-add) of a work entry ``e`` (``clouds``,
    ``forwards``, ``balls``): per branch and distinct slot 3 C1 + C1 C2 +
    C2 C3; per level the distances of distinct centres to distinct database
    rows (3 each); the second level's hoisted feature rows, 320 C1 a
    distinct row; the group-all level's three layers per distinct
    second-level centre; the head.  FPS (no product) is not counted."""
    macs, feat = 0.0, 0
    for level in ("sa1", "sa2"):
        spec, counts = cfg[level], e["balls"][level]
        macs += 3 * counts["centres_db"]
        for b, (c1, c2, c3) in enumerate(spec["mlps"]):
            macs += counts["slots"][b] * (3 * c1 + c1 * c2 + c2 * c3)
            macs += counts["db"] * feat * c1
        feat = sum(m[-1] for m in spec["mlps"])
    c_in = feat + 3
    for f in cfg["sa3_mlp"]:
        macs += e["balls"]["sa2"]["centres"] * c_in * f
        c_in = f
    for f in cfg["fc_widths"] + [cfg["num_classes"]]:
        macs += e["clouds"] * c_in * f
        c_in = f
    return 2.0 * e["forwards"] * macs
