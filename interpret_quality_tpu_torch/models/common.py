"""Shared eval-mode building blocks for the classifiers.

Models keep the reference's torch modules (``Conv1d``/``Conv2d`` with kernel
size 1, ``Linear``, ``BatchNorm``) so reference state dicts load by name,
but compute on channels-last ``(B, N, C)`` tensors: a 1x1 convolution is a
matmul with the weight viewed as ``(out, in)``, which never goes through
cuDNN (and its TF32 default).  BatchNorm is the eval-mode affine map with
the running statistics, eps 1e-5.  The edge-conv family activates with
LeakyReLU(0.2), the other families with ReLU.  ``fold_stack`` turns a
ConvBN stack into the explicit affine maps the set-abstraction kernels take.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def pointwise(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Apply a 1x1 Conv1d/Conv2d or a Linear over the channel axis of a
    channels-last tensor: x (..., in) -> (..., out)."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)         # (out, in)
    y = torch.matmul(x, w.T)
    return y if layer.bias is None else y + layer.bias


def bn_affine(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as (alpha, beta) with bn(x) = alpha * x + beta."""
    alpha = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return alpha, bn.bias - alpha * bn.running_mean


def bn_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Eval BatchNorm over the last (channel) axis, in the same order of
    operations as flax's: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


def conv_bn_stack(c_in: int, widths: Sequence[int]
                  ) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """The reference's (mlp_convs, mlp_bns) pair: 1x1 Conv2d layers of the
    given widths from c_in, each with its BatchNorm2d."""
    convs, bns = nn.ModuleList(), nn.ModuleList()
    for c_out in widths:
        convs.append(nn.Conv2d(c_in, c_out, 1))
        bns.append(nn.BatchNorm2d(c_out))
        c_in = c_out
    return convs, bns


def conv_bn_relu(x: torch.Tensor, conv: nn.Module, bn: nn.Module) -> torch.Tensor:
    """relu(bn(conv(x))) over the channel axis of a channels-last tensor."""
    return torch.relu(bn_eval(pointwise(x, conv), bn))


def mlp_stack(x: torch.Tensor, convs, bns) -> torch.Tensor:
    """A per-point MLP of ConvBN + ReLU layers (the JAX ``MLPStack``)."""
    for conv, bn in zip(convs, bns):
        x = conv_bn_relu(x, conv, bn)
    return x


def fold_stack(convs, bns):
    """A ConvBN stack's eval layers as affine maps [(A_i, b_i)], A_i (in,
    out), with bn(conv(x)) = x @ A + b, so each layer is relu(x @ A + b).
    Computed from the weights and the running statistics (the counterpart
    of ``MLPStack(fold=True)``, which probes the layers with [0; I])."""
    folded = []
    for conv, bn in zip(convs, bns):
        w = conv.weight.reshape(conv.weight.shape[0], -1)       # (out, in)
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        folded.append((w.T * mul, (conv.bias - bn.running_mean) * mul + bn.bias))
    return folded


def set_fp32_matmuls() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """The torch device for a config's ``device``.  Asking for CUDA on a
    machine without it raises; nothing continues on the CPU."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                               "available; pass --device cpu to run on the CPU")
        set_fp32_matmuls()
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")
