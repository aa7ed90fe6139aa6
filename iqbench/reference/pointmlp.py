"""PointMLP (Ma, Qin, You, Ran and Fu, "Rethinking Network Design and Local
Geometry in Point Cloud: A Simple Residual MLP Framework", ICLR 2022,
arXiv:2202.07123), the full classifier ``pointMLP()`` of the public release
(pointMLP-pytorch, ``classification_ModelNet40/models/pointmlp.py``), in
plain PyTorch as its equations read.

  * ``embedding``: a 1x1 convolution without bias (3 -> 64), BatchNorm,
    ReLU.
  * Four stages (``stages``: 512, 256, 128 and 64 anchors of 24
    neighbours, widths 128, 256, 512 and 1024).  Each takes its anchors by
    FPS and each anchor's 24 nearest of the stage's points in xyz; with
    d_sj = f_j - f_s, the anchor's features subtracted from its
    neighbours', sigma_b is ``torch.std`` (unbiased) over all of cloud b's
    S K C_in values of d, and g = alpha * d / (sigma_b + 1e-5) + beta
    (``local_grouper_list.i``, ``normalize="anchor"``, no xyz in the
    groups).  [g, f_s] goes through ``transfer`` (a 1x1 convolution 2 C_in
    -> C without bias, BatchNorm, ReLU) and two residual blocks
    relu(BN(W2 relu(BN(W1 x))) + x), then the max over the 24; two more
    residual blocks run on the anchors (``pos_blocks_list.i``).
  * The max over the last 64 points, then the classifier: Linear 1024 ->
    512, BatchNorm, ReLU, Linear 512 -> 256, BatchNorm, ReLU, Linear 256 ->
    classes (the dropouts are the identity in eval).

Nothing is hoisted and no BatchNorm is folded.  Departures from the
release, each the port's too:
  * FPS starts at index 0, ties to the lowest index (``pointnet2.fps``; the
    release's CUDA FPS starts at index 0 too, its ties unstated);
  * the kNN keeps ties to the lowest index, on the distance expression of
    ``pointconv.knn`` (the release's ``topk(sorted=False)`` order does not
    matter: the std and the max are over sets);
  * ``num_classes`` 10 (ModelNet10, the repository's dataset) for the
    published 40.

``forward`` is the eval forward; ``plan`` gives each stage's FPS and kNN
indices (the enumeration computes them once per chunk of masked clouds,
before the poses move them: they depend on distances alone), else they are
computed here.  The caller computes in chunks of clouds
(``attribution.logits``' blocks of 50): a stage of 50 clouds holds about
0.3 GB a grouped tensor.

Beside the model, what the benchmark's shared code asks of a family:
``leaves`` (the seeded state dict's layout), ``extra_counts`` (per stage
the distinct anchors, database rows and slots of a batch of masked clouds)
and ``flops``.
"""
from __future__ import annotations

import torch

from .common import bn_eval, distinct_per_row, first_mask, gather
from .pointconv import knn
from .pointnet2 import fps

BLOCK = 50          # clouds per block of extra_counts' kNN


def _conv(h: torch.Tensor, state, name: str) -> torch.Tensor:
    """A 1x1 convolution or Linear ``name`` over the last axis of h."""
    w = state[name + ".weight"]
    h = h @ w.reshape(w.shape[0], -1).T
    bias = state.get(name + ".bias")
    return h if bias is None else h + bias


def _cbr(h, state, prefix: str) -> torch.Tensor:
    """``ConvBNReLU1D`` ``prefix``: relu(BN(conv(h)))."""
    return torch.relu(bn_eval(_conv(h, state, prefix + ".0"), state,
                              prefix + ".1"))


def _res(h, state, prefix: str) -> torch.Tensor:
    """``ConvBNReLURes1D`` ``prefix``: relu(BN(W2 relu(BN(W1 h))) + h)."""
    y = _cbr(h, state, prefix + ".net1")
    return torch.relu(bn_eval(_conv(y, state, prefix + ".net2.0"), state,
                              prefix + ".net2.1") + h)


def stage_plan(spec, xyz: torch.Tensor):
    """A stage's (FPS indices, kNN indices) of clouds xyz (B, N, 3)."""
    fps_idx = fps(xyz, spec["anchors"])
    return fps_idx, knn(spec["k"], xyz, gather(xyz, fps_idx))


def plan(cfg, x: torch.Tensor):
    """Per stage (FPS indices, kNN indices) of clouds x, as the
    enumeration's plan."""
    stages, xyz = [], x
    for spec in cfg["stages"]:
        stages.append(stage_plan(spec, xyz))
        xyz = gather(xyz, stages[-1][0])
    return tuple(stages)


def stage(state, cfg, i: int, f: torch.Tensor, fps_idx, idx) -> torch.Tensor:
    """Stage i on the features f (B, N, C_in) -> (B, S, C)."""
    B = f.shape[0]
    fs = gather(f, fps_idx)                                 # (B, S, C_in)
    d = gather(f, idx) - fs[:, :, None, :]                  # (B, S, K, C_in)
    std = torch.std(d.reshape(B, -1), dim=-1)
    name = f"local_grouper_list.{i}"
    g = (state[name + ".affine_alpha"] * d / (std + cfg["std_eps"])[:, None, None, None]
         + state[name + ".affine_beta"])
    h = _cbr(torch.cat([g, fs[:, :, None, :].expand_as(g)], dim=-1), state,
             f"pre_blocks_list.{i}.transfer.net")
    for j in range(cfg["pre_blocks"][i]):
        h = _res(h, state, f"pre_blocks_list.{i}.operation.{j}")
    h = h.amax(dim=2)
    for j in range(cfg["pos_blocks"][i]):
        h = _res(h, state, f"pos_blocks_list.{i}.operation.{j}")
    return h


def forward(state, cfg, x: torch.Tensor, stages=None) -> torch.Tensor:
    """Eval logits (B, classes) of clouds x (B, N, 3); ``stages`` the plan
    (``plan``), else made here."""
    if stages is None:
        stages = plan(cfg, x)
    f = _cbr(x, state, "embedding.net")
    for i, (fps_idx, idx) in enumerate(stages):
        f = stage(state, cfg, i, f, fps_idx, idx)
    h = f.amax(dim=1)
    h = torch.relu(bn_eval(_conv(h, state, "classifier.0"), state, "classifier.1"))
    h = torch.relu(bn_eval(_conv(h, state, "classifier.4"), state, "classifier.5"))
    return _conv(h, state, "classifier.8")


def _conv_leaf(name: str, c_out: int, c_in: int):
    return ([name + ".weight"], (c_out, c_in, 1), "b", c_in)


def _res_leaves(prefix: str, c: int):
    return [_conv_leaf(prefix + ".net1.0", c, c), ([prefix + ".net1.1"], c, "bn"),
            _conv_leaf(prefix + ".net2.0", c, c), ([prefix + ".net2.1"], c, "bn")]


def leaves(cfg):
    """(names sharing one tensor, shape or width, kind[, fan_in]) of the
    state dict, kind ``w`` a product, ``b`` a bias, ``bn`` a BatchNorm.
    Every product is drawn as kind ``b`` of its fan-in, uniform in
    +-1/sqrt(fan_in): PyTorch's default for Conv1d and Linear, which the
    release keeps (He-uniform, kind ``w``, grows 20 residual layers with
    randomised BatchNorms to logits of RMS 3e3, where f32 rounding alone
    moves a logit by more than ``faults.answer_altered``'s 0.05).  The
    affine's alpha and beta are drawn as biases of fan-in 1, uniform in +-1
    (the release starts them at 1 and 0)."""
    e = cfg["embed"]
    out = [_conv_leaf("embedding.net.0", e, 3), (["embedding.net.1"], e, "bn")]
    c_in = e
    for i, spec in enumerate(cfg["stages"]):
        c = spec["width"]
        name = f"local_grouper_list.{i}"
        out += [([name + ".affine_alpha"], (1, 1, 1, c_in), "b", 1),
                ([name + ".affine_beta"], (1, 1, 1, c_in), "b", 1)]
        pre = f"pre_blocks_list.{i}"
        out += [_conv_leaf(pre + ".transfer.net.0", c, 2 * c_in),
                ([pre + ".transfer.net.1"], c, "bn")]
        for j in range(cfg["pre_blocks"][i]):
            out += _res_leaves(f"{pre}.operation.{j}", c)
        for j in range(cfg["pos_blocks"][i]):
            out += _res_leaves(f"pos_blocks_list.{i}.operation.{j}", c)
        c_in = c
    for lin, bn, f in (("classifier.0", "classifier.1", cfg["fc_widths"][0]),
                       ("classifier.4", "classifier.5", cfg["fc_widths"][1])):
        out += [([lin + ".weight"], (f, c_in), "b", c_in),
                ([lin + ".bias"], (f,), "b", c_in), ([bn], f, "bn")]
        c_in = f
    k = cfg["num_classes"]
    out += [(["classifier.8.weight"], (k, c_in), "b", c_in),
            (["classifier.8.bias"], (k,), "b", c_in)]
    return out


def stage_counts(cfg, x: torch.Tensor, ident: torch.Tensor) -> list:
    """Per stage of clouds x (M, N, 3) whose points have the identities
    ``ident`` (M, N) (equal identity, equal point): the distinct anchors,
    the distinct database rows, the distinct anchors times the distinct
    rows (each summed over the clouds), and the distinct points among each
    distinct anchor's k nearest, summed, found with this module's FPS and
    kNN on the clouds as they are (the plan's groups; translation keeps
    distances)."""
    absent = int(ident.max()) + 1
    out = []
    for spec in cfg["stages"]:
        idx = fps(x, spec["anchors"])
        cx, ci = gather(x, idx), ident.gather(1, idx)
        centre = first_mask(ci)                             # distinct anchors
        c = centre.sum(-1).double()
        db = distinct_per_row(ident, absent).double()
        slots = 0
        for s in range(0, x.shape[0], BLOCK):
            nb = knn(spec["k"], x[s:s + BLOCK], cx[s:s + BLOCK])
            ids = ident[s:s + BLOCK].gather(
                1, nb.reshape(nb.shape[0], -1)).reshape(nb.shape)
            slots += int((distinct_per_row(ids, absent)
                          * centre[s:s + BLOCK]).sum())
        out.append({"centres": int(c.sum()), "db": int(db.sum()),
                    "centres_db": int((c * db).sum()), "slots": slots})
        x, ident = cx, ci
    return out


def extra_counts(cfg, masked: torch.Tensor, ident: torch.Tensor) -> dict:
    """What ``flops`` and kernel 11's readers read beyond the distinct
    points: ``stages`` (``stage_counts``)."""
    return {"stages": stage_counts(cfg, masked, ident)}


def flops(cfg, e) -> float:
    """Operations (2 a multiply-add) of a work entry ``e`` (``clouds``,
    ``d``, ``forwards``, ``plans``, ``stages``).  Per forward: the embedding
    on each cloud's distinct points; per stage (C_in -> C), the transfer
    hoisted (C_in C on each distinct database row for u, C_in C on each
    distinct anchor for its own share), the two residual blocks' four C^2
    products on each distinct slot of a distinct anchor, and the
    pos-blocks' four C^2 on each distinct anchor; the classifier once a
    cloud.  Per plan: the kNN's distances from distinct anchors to distinct
    rows, 3 each.  FPS and the standard deviation (no product) are not
    counted."""
    st, e0 = e["stages"], cfg["embed"]
    macs = float(e["d"].astype(float).sum()) * 3 * e0
    c_in = e0
    for i, (counts, spec) in enumerate(zip(st, cfg["stages"])):
        c = spec["width"]
        macs += (counts["db"] + counts["centres"]) * c_in * c
        macs += counts["slots"] * 2 * cfg["pre_blocks"][i] * c * c
        macs += counts["centres"] * 2 * cfg["pos_blocks"][i] * c * c
        c_in = c
    for f in cfg["fc_widths"] + [cfg["num_classes"]]:
        macs += e["clouds"] * c_in * f
        c_in = f
    dist = sum(counts["centres_db"] for counts in st)
    return 2.0 * (e["forwards"] * macs + e["plans"] * 3 * dist)
