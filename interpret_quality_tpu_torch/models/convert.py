"""Weights across the two packages.

``state_dict_from_jax`` maps the JAX package's variables (nested dicts of
numpy arrays, ``{"params": ..., "batch_stats": ...}``) onto this package's
modules.  It is the port's own copy of the export rules of
``interpret_quality_tpu/models/torch_convert.py:30-135, 207-274``, with the
per-tensor layout read from the port model's own ``state_dict()``.

``load_reference_state_dict`` reads a reference ``.t7/.pth/.pt`` state dict
(DataParallel ``module.`` prefixes stripped); the port's modules carry the
reference's names, so it loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# a rule: (torch_prefix, jax_path, kind)
#   "conv":    <prefix>.weight[.bias]            <- <path>/{kernel,bias}
#   "bn":      <prefix>.{weight,bias,running_*}  <- params <path>/{scale,bias},
#                                                   batch_stats <path>/{mean,var}
#   "bn_flat": as "bn", from an EdgeConv's flat bn_{scale,bias,mean,var}
Rule = Tuple[str, Tuple[str, ...], str]


def dgcnn_rules() -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3, 4):
        r.append((f"conv{i}.0", (f"conv{i}",), "conv"))
        # each BN is registered twice (self.bn{i} and conv{i}.1): the state
        # dict carries both names for the one tensor, and both get values
        r.append((f"bn{i}", (f"conv{i}",), "bn_flat"))
        r.append((f"conv{i}.1", (f"conv{i}",), "bn_flat"))
    r.append(("conv5.0", ("conv5", "conv"), "conv"))
    r.append(("bn5", ("conv5", "bn"), "bn"))
    r.append(("conv5.1", ("conv5", "bn"), "bn"))
    r.append(("linear1", ("linear1",), "conv"))
    r.append(("bn6", ("bn6",), "bn"))
    r.append(("linear2", ("linear2",), "conv"))
    r.append(("bn7", ("bn7",), "bn"))
    r.append(("linear3", ("linear3",), "conv"))
    return r


def _stn_rules(tprefix: str, path: Tuple[str, ...]) -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3):
        r.append((f"{tprefix}.conv{i}", path + (f"conv{i}", "conv"), "conv"))
        r.append((f"{tprefix}.bn{i}", path + (f"conv{i}", "bn"), "bn"))
    r.append((f"{tprefix}.fc1", path + ("fc1", "fc"), "conv"))
    r.append((f"{tprefix}.bn4", path + ("fc1", "bn"), "bn"))
    r.append((f"{tprefix}.fc2", path + ("fc2", "fc"), "conv"))
    r.append((f"{tprefix}.bn5", path + ("fc2", "bn"), "bn"))
    r.append((f"{tprefix}.fc3", path + ("fc3",), "conv"))
    return r


def pointnet_rules() -> List[Rule]:
    r = _stn_rules("feat.stn", ("feat", "stn"))
    r += _stn_rules("feat.fstn", ("feat", "fstn"))
    for i in (1, 2, 3):
        r.append((f"feat.conv{i}", ("feat", f"conv{i}", "conv"), "conv"))
        r.append((f"feat.bn{i}", ("feat", f"conv{i}", "bn"), "bn"))
    r.append(("fc1", ("fc1", "fc"), "conv"))
    r.append(("bn1", ("fc1", "bn"), "bn"))
    r.append(("fc2", ("fc2",), "conv"))
    r.append(("bn2", ("bn2",), "bn"))
    r.append(("fc3", ("fc3",), "conv"))
    return r


def _head_rules() -> List[Rule]:
    return ([(name, (name,), "conv") for name in ("fc1", "fc2", "fc3")]
            + [(name, (name,), "bn") for name in ("bn1", "bn2")])


def pointnet2_rules() -> List[Rule]:
    from .pointnet2 import SA1, SA2, SA3
    r: List[Rule] = []
    for sa, level in (("sa1", SA1), ("sa2", SA2)):
        for bi, mlp in enumerate(level[3]):
            for j in range(len(mlp)):
                r.append((f"{sa}.conv_blocks.{bi}.{j}",
                          (sa, f"branch{bi}", f"layer{j}", "conv"), "conv"))
                r.append((f"{sa}.bn_blocks.{bi}.{j}",
                          (sa, f"branch{bi}", f"layer{j}", "bn"), "bn"))
    for j in range(len(SA3)):
        r.append((f"sa3.mlp_convs.{j}", ("sa3", "mlp", f"layer{j}", "conv"), "conv"))
        r.append((f"sa3.mlp_bns.{j}", ("sa3", "mlp", f"layer{j}", "bn"), "bn"))
    return r + _head_rules()


def pointconv_rules() -> List[Rule]:
    r: List[Rule] = []
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            r.append((f"{sa}.mlp_convs.{j}", (sa, "mlp", f"layer{j}", "conv"), "conv"))
            r.append((f"{sa}.mlp_bns.{j}", (sa, "mlp", f"layer{j}", "bn"), "bn"))
        for net in ("weightnet", "densitynet"):     # 3->8->8->16, 1->16->8->1
            for j in range(3):
                r.append((f"{sa}.{net}.mlp_convs.{j}",
                          (sa, net, "mlp", f"layer{j}", "conv"), "conv"))
                r.append((f"{sa}.{net}.mlp_bns.{j}",
                          (sa, net, "mlp", f"layer{j}", "bn"), "bn"))
        r.append((f"{sa}.linear", (sa, "linear"), "conv"))
        r.append((f"{sa}.bn_linear", (sa, "bn_linear"), "bn"))
    return r + _head_rules()


RULES = {"pointnet": pointnet_rules, "pointnet2": pointnet2_rules,
         "pointconv": pointconv_rules, "dgcnn": dgcnn_rules,
         "gcnn": dgcnn_rules, "gcnn_adv": dgcnn_rules}


def _get(tree: dict, path: Tuple[str, ...], leaf: str):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node[leaf])


def state_dict_from_jax(model_name: str, variables: Dict,
                        k: int = 20) -> Dict[str, torch.Tensor]:
    """The port model's state dict holding the JAX variables' values."""
    from .registry import build_model
    if model_name not in RULES:
        raise NotImplementedError(f"no weight rules for {model_name!r} yet")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    # the classifier's last layer: fc3 (PointNet, PointNet++, PointConv) or
    # linear3 (the edge-conv family)
    last = "fc3" if "fc3" in params else "linear3"
    num_classes = _get(params, (last,), "kernel").shape[1]
    template = build_model(model_name, num_classes, k).state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray):
        if key not in template:
            raise KeyError(f"{key} not in the {model_name} state dict")
        shape = tuple(template[key].shape)
        if value.size != int(np.prod(shape)):
            raise ValueError(f"{key}: {value.shape} does not fit {shape}")
        # a copy: the JAX package's arrays are read-only
        out[key] = torch.from_numpy(np.array(value.reshape(shape),
                                             dtype=np.float32))

    for tprefix, path, kind in RULES[model_name]():
        if kind == "conv":
            put(f"{tprefix}.weight", _get(params, path, "kernel").T)
            if f"{tprefix}.bias" in template:
                put(f"{tprefix}.bias", _get(params, path, "bias"))
        else:
            pre = "bn_" if kind == "bn_flat" else ""
            put(f"{tprefix}.weight", _get(params, path, pre + "scale"))
            put(f"{tprefix}.bias", _get(params, path, pre + "bias"))
            put(f"{tprefix}.running_mean", _get(stats, path, pre + "mean"))
            put(f"{tprefix}.running_var", _get(stats, path, pre + "var"))
    # the only keys the JAX variables lack are BN step counters; anything
    # else left over means a rule is missing
    leftover = [key for key in template if key not in out]
    unmapped = [key for key in leftover
                if not key.endswith("num_batches_tracked")]
    if unmapped:
        raise ValueError(f"no rule gives a value for {unmapped}")
    for key in leftover:
        out[key] = template[key].clone()
    return out


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.t7/.pth/.pt`` state dict, ``module.`` prefixes
    stripped."""
    state = torch.load(path, map_location="cpu")
    return {(key[len("module."):] if key.startswith("module.") else key): v
            for key, v in state.items()}
