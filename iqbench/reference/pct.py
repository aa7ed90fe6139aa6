"""PCT (Guo, Cai, Liu, Mu, Martin and Hu, "PCT: Point Cloud Transformer",
arXiv:2012.09688, 2021), the full classifier with neighbour embedding and
four offset-attention layers, in the layout of the public PyTorch release
(class ``Pct`` of PCT_Pytorch's ``model.py``), in plain PyTorch as its
equations read (§3 of the paper, Fig. 2's widths).

  * Embedding: two 1x1 convolutions without bias (3 -> 64 -> 64), each with
    BatchNorm and ReLU.
  * Sample and group, twice (``sa1``: 512 centres of the 1024 points, then
    ``sa2``: 256 of those 512): FPS takes the centres, each takes its 32
    nearest points in xyz, and each neighbour's features f_j enter as
    [f_j - f_c, f_c]; two 1x1 convolutions without bias (``gather_local_i``,
    2C -> C' -> C'), each with BatchNorm and ReLU, then the max over the 32.
  * ``pt_last``: two 1x1 convolutions without bias (256 -> 256), BatchNorm,
    ReLU; then four offset-attention layers in turn.  In each, Q and K are
    one tied weight (256 -> 64, no bias), the energy E = Q K^T has no
    1/sqrt(d) scale, each row goes through a softmax and each column is then
    divided by its sum over the rows plus 1e-9; V = W_v x + b_v,
    x_r[j] = sum_i A[i, j] V[i], and the layer returns
    x + ReLU(BN(W_t (x - x_r) + b_t)).
  * The fuse layer: the four attention outputs and the second level's
    features (1280 wide) through a 1x1 convolution without bias to 1024,
    BatchNorm, LeakyReLU(0.2), then the max over the points.
  * The head: Linear 1024 -> 512 without bias, BatchNorm, LeakyReLU(0.2),
    Linear 512 -> 256, BatchNorm, LeakyReLU(0.2), Linear 256 -> classes (the
    dropouts are the identity in eval).

Departures from the paper's text, each the port's too:
  * the fuse layer pools by the max alone, where the paper pools max and
    mean, and the head activates with LeakyReLU: both as the PyTorch
    release has them;
  * FPS starts at index 0, ties to the lowest index (``pointnet2.fps``; the
    release's CUDA FPS starts at index 0 too, its ties unstated);
  * the kNN keeps ties to the lowest index, on the distance expression of
    ``pointconv.knn`` (the port's kNN kernel computes it so).

``forward`` is the eval forward; ``plan`` gives each level's FPS and kNN
indices (the enumeration computes them once per chunk of masked clouds,
before the poses move them: they depend on distances alone), else they are
computed here.

Beside the model, what the benchmark's shared code asks of a family:
``leaves`` (the seeded state dict's layout, the tied Q/K weight one leaf
with two names), ``extra_counts`` (the kNN groups' counts of a batch of
masked clouds, ``pointconv.group_counts``) and ``flops``.
"""
from __future__ import annotations

import torch

from .common import bn_eval, gather
from .pointconv import group_counts, knn
from .pointnet2 import fps

LEVELS = ("sa1", "sa2")
LEAKY_SLOPE = 0.2
COLUMN_EPS = 1e-9


def _conv(h: torch.Tensor, state, name: str) -> torch.Tensor:
    """A 1x1 convolution or Linear ``name`` over the last axis of h."""
    w = state[name + ".weight"]
    h = h @ w.reshape(w.shape[0], -1).T
    bias = state.get(name + ".bias")
    return h if bias is None else h + bias


def _conv_bn_relu(h, state, conv: str, bn: str) -> torch.Tensor:
    return torch.relu(bn_eval(_conv(h, state, conv), state, bn))


def _leaky(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h > 0, h, LEAKY_SLOPE * h)


def level_plan(spec, xyz: torch.Tensor):
    """A level's (FPS indices, kNN indices) of clouds xyz (B, N, 3)."""
    fps_idx = fps(xyz, spec["npoint"])
    return fps_idx, knn(spec["nsample"], xyz, gather(xyz, fps_idx))


def plan(cfg, x: torch.Tensor):
    """Per level (FPS indices, kNN indices) of clouds x, as the
    enumeration's plan."""
    levels, xyz = [], x
    for level in LEVELS:
        levels.append(level_plan(cfg[level], xyz))
        xyz = gather(xyz, levels[-1][0])
    return tuple(levels)


def sample_and_group(state, i: int, f: torch.Tensor, fps_idx, idx):
    """``gather_local_i`` on the groups: f (B, N, C) -> (B, S, C')."""
    fc = gather(f, fps_idx)[:, :, None, :]                  # (B, S, 1, C)
    fj = gather(f, idx)                                     # (B, S, K, C)
    e = torch.cat([fj - fc, fc.expand_as(fj)], dim=-1)      # (B, S, K, 2C)
    name = f"gather_local_{i}"
    h = _conv_bn_relu(e, state, name + ".conv1", name + ".bn1")
    h = _conv_bn_relu(h, state, name + ".conv2", name + ".bn2")
    return h.amax(dim=2)


def offset_attention(state, name: str, x: torch.Tensor) -> torch.Tensor:
    """One offset-attention layer ``name`` on x (B, N, C)."""
    q = _conv(x, state, name + ".q_conv")                   # (B, N, C/4)
    k = _conv(x, state, name + ".k_conv")
    energy = q @ k.transpose(1, 2)                          # (B, N, N)
    att = torch.softmax(energy, dim=-1)
    att = att / (COLUMN_EPS + att.sum(dim=1, keepdim=True))
    v = _conv(x, state, name + ".v_conv")                   # (B, N, C)
    x_r = att.transpose(1, 2) @ v                   # sum_i A[i, j] v[i]
    return x + torch.relu(bn_eval(_conv(x - x_r, state, name + ".trans_conv"),
                                  state, name + ".after_norm"))


def forward(state, cfg, x: torch.Tensor, levels=None) -> torch.Tensor:
    """Eval logits (B, classes) of clouds x (B, N, 3); ``levels`` the plan
    (``plan``), else made here."""
    if levels is None:
        levels = plan(cfg, x)
    f = _conv_bn_relu(x, state, "conv1", "bn1")
    f = _conv_bn_relu(f, state, "conv2", "bn2")
    for i, (fps_idx, idx) in enumerate(levels):
        f = sample_and_group(state, i, f, fps_idx, idx)
    h = _conv_bn_relu(f, state, "pt_last.conv1", "pt_last.bn1")
    h = _conv_bn_relu(h, state, "pt_last.conv2", "pt_last.bn2")
    outs = []
    for i in range(1, cfg["attention"]["layers"] + 1):
        h = offset_attention(state, f"pt_last.sa{i}", h)
        outs.append(h)
    h = torch.cat(outs + [f], dim=-1)                       # (B, S, 1280)
    h = _leaky(bn_eval(_conv(h, state, "conv_fuse.0"), state, "conv_fuse.1"))
    h = h.amax(dim=1)
    h = _leaky(bn_eval(_conv(h, state, "linear1"), state, "bn6"))
    h = _leaky(bn_eval(_conv(h, state, "linear2"), state, "bn7"))
    return _conv(h, state, "linear3")


def _w(name: str, c_out: int, c_in: int, conv: bool = True):
    shape = (c_out, c_in, 1) if conv else (c_out, c_in)
    return ([name + ".weight"], shape, "w")


def leaves(cfg):
    """(names sharing one tensor, shape or width, kind[, fan_in]) of the
    state dict, kind ``w`` a product, ``b`` a bias, ``bn`` a BatchNorm."""
    e1, e2 = cfg["embed"]
    out = [_w("conv1", e1, 3), (["bn1"], e1, "bn"),
           _w("conv2", e2, e1), (["bn2"], e2, "bn")]
    feat = e2
    for i, level in enumerate(LEVELS):
        c1, c2 = cfg[level]["mlp"]
        name = f"gather_local_{i}"
        out += [_w(name + ".conv1", c1, 2 * feat), ([name + ".bn1"], c1, "bn"),
                _w(name + ".conv2", c2, c1), ([name + ".bn2"], c2, "bn")]
        feat = c2
    att = cfg["attention"]
    c, qk = att["channels"], att["qk"]
    out += [_w("pt_last.conv1", c, feat), (["pt_last.bn1"], c, "bn"),
            _w("pt_last.conv2", c, c), (["pt_last.bn2"], c, "bn")]
    for i in range(1, att["layers"] + 1):
        name = f"pt_last.sa{i}"
        out += [([name + ".q_conv.weight", name + ".k_conv.weight"],
                 (qk, c, 1), "w"),
                _w(name + ".v_conv", c, c),
                ([name + ".v_conv.bias"], (c,), "b", c),
                _w(name + ".trans_conv", c, c),
                ([name + ".trans_conv.bias"], (c,), "b", c),
                ([name + ".after_norm"], c, "bn")]
    width = att["layers"] * c + feat
    out += [_w("conv_fuse.0", cfg["fuse"], width),
            (["conv_fuse.1"], cfg["fuse"], "bn")]
    c_in = cfg["fuse"]
    for i, f in enumerate(cfg["fc_widths"], 1):
        out.append(_w(f"linear{i}", f, c_in, conv=False))
        if i > 1:
            out.append(([f"linear{i}.bias"], (f,), "b", c_in))
        out.append(([f"bn{5 + i}"], f, "bn"))
        c_in = f
    i = len(cfg["fc_widths"]) + 1
    out += [_w(f"linear{i}", cfg["num_classes"], c_in, conv=False),
            ([f"linear{i}.bias"], (cfg["num_classes"],), "b", c_in)]
    return out


def extra_counts(cfg, masked: torch.Tensor, ident: torch.Tensor) -> dict:
    """What ``flops`` and kernel 10's readers read beyond the distinct
    points: ``groups`` (``pointconv.group_counts``: per level the distinct
    centres, database rows and slots)."""
    return {"groups": group_counts(cfg, masked, ident)}


def flops(cfg, e) -> float:
    """Operations (2 a multiply-add) of a work entry ``e`` (``clouds``,
    ``d``, ``forwards``, ``plans``, ``groups``).  Per forward: the embedding
    on each cloud's distinct points; per level, layer 1 hoisted (C C1 on
    each distinct database row, C C1 on each distinct centre) and layer 2,
    C1 C2, on each distinct slot of a distinct centre; ``pt_last``'s two
    convolutions, each attention layer's Q, V and W_t products on the
    distinct second-level centres, its energy (qk) and x_r (C) on each pair
    of them, and the fuse layer on them; the head once a cloud.  Per plan:
    the kNN's distances from distinct centres to distinct rows, 3 each.  FPS
    (no product) is not counted."""
    g, (e1, e2) = e["groups"], cfg["embed"]
    macs = float(e["d"].astype(float).sum()) * (3 * e1 + e1 * e2)
    feat = e2
    for level in LEVELS:
        counts, (c1, c2) = g[level], cfg[level]["mlp"]
        macs += (counts["db"] + counts["centres"]) * feat * c1
        macs += counts["slots"] * c1 * c2
        feat = c2
    att, top = cfg["attention"], g["sa2"]
    c, qk, layers = att["channels"], att["qk"], att["layers"]
    macs += top["centres"] * (feat * c + c * c)
    macs += layers * (top["centres"] * (c * qk + 2 * c * c)
                      + top["centres_sq"] * (qk + c))
    macs += top["centres"] * (layers * c + feat) * cfg["fuse"]
    c_in = cfg["fuse"]
    for f in cfg["fc_widths"] + [cfg["num_classes"]]:
        macs += e["clouds"] * c_in * f
        c_in = f
    dist = sum(g[level]["centres_db"] for level in LEVELS)
    return 2.0 * (e["forwards"] * macs + e["plans"] * 3 * dist)
