"""Shared building blocks for the classifiers.

Models keep the reference's torch modules (``Conv1d``/``Conv2d`` with kernel
size 1, ``Linear``, ``BatchNorm``) so reference state dicts load by name,
but compute on channels-last ``(B, N, C)`` tensors: a 1x1 convolution is a
matmul with the weight viewed as ``(out, in)``, which never goes through
cuDNN (and its TF32 default).  BatchNorm, eps 1e-5, is the eval-mode affine
map with the running statistics, or in training (``bn.training``) the
normalisation by the batch statistics of ``batch_norm``, which also updates
the running statistics as the JAX package does.  The edge-conv family
activates with LeakyReLU(0.2), the other families with ReLU.  ``fold_stack``
turns a ConvBN stack into the explicit affine maps the set-abstraction
kernels take.

Products and the matmul precision (``--matmul_precision``,
``config.matmul_precision``).  The JAX package leaves some products'
precision to its process-global setting and pins others to HIGHEST; the
port's counterparts follow the same rule on the card, through
``ops.precision.matmul`` (which says what each setting computes; on the
CPU every setting computes f32, as XLA:CPU does).

Following the setting (JAX leaves them unpinned):
  * ``pointwise``: every 1x1 convolution and Linear of the five families,
    eval and training (JAX ``nn.Dense``, ``models/common.py:34-39`` there);
  * DGCNN's hoisted ``x @ W1`` and ``x @ (W2 - W1)`` (``models/dgcnn.py``);
  * the hoisted layer-1 rows: PointConv's ``u`` and ``csw``, PointNet++'s
    ``uf`` (``models/pointconv.py``, ``models/pointnet2.py``);
  * PointNet's input and feature transforms (``models/pointnet.py``);
  * ``ops.geometry.square_distance`` (PointConv's KDE density) and
    ``attrib.shapley.region_id_from_fps``'s ``data @ centers.T``, so at
    ``default`` region ids may differ from ``highest``'s, as on the TPU;
  * inside kernels 5 and 7 (``ops/cuda/groups.py``): layers 2-3 on the
    tensor cores and kernel 7's WeightNet on the f32 units, at ``high`` on
    TF32-rounded and at ``default`` on bf16-rounded operands.
Pinned to f32 at every setting (JAX pins them to HIGHEST, or computes them
elementwise on the VPU):
  * the kNN distances of kernels 1, 3 and 6 and their plain versions, and
    the ball query of kernel 5;
  * kernel 7's contraction over the neighbours (three TF32 products) and
    every elementwise product.
Left f32 though the JAX package leaves them unpinned (a difference of the
port): kernel 5's layer-1 product of the xyz offsets, DensityNet's
products in kernel 7's wrapper, the rotations of the perturbations
(``ops/transforms.py``), PointConv's un-fused contraction (``einsum``),
PointNet's feature-transform regulariser, and the smoothness engine's
projections.

``ops.precision.matmul`` is differentiable, its backward products at the
same setting, so training and the smoothness step see the setting too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.precision import matmul, set_matmul_precision
from ..parallel import data_parallel

BN_EPS = 1e-5
BN_MOMENTUM = 0.1     # torch's; flax's momentum 0.9 is the same update
LEAKY_SLOPE = 0.2


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def pointwise(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Apply a 1x1 Conv1d/Conv2d or a Linear over the channel axis of a
    channels-last tensor: x (..., in) -> (..., out), the product at the
    matmul precision (``ops.precision.matmul``)."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)         # (out, in)
    y = matmul(x, w.T)
    return y if layer.bias is None else y + layer.bias


def bn_affine(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as (alpha, beta) with bn(x) = alpha * x + beta."""
    alpha = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return alpha, bn.bias - alpha * bn.running_mean


def bn_eval_terms(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as (mean, mul, bias) with bn(x) = (x - mean) * mul +
    bias, mul = rsqrt(var + eps) * scale: ``bn_eval``'s operands, which
    kernel 9 (``ops.cuda.dense``) applies in the same order."""
    return (bn.running_mean, torch.rsqrt(bn.running_var + BN_EPS) * bn.weight,
            bn.bias)


def bn_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Eval BatchNorm over the last (channel) axis, in the same order of
    operations as flax's: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mean, mul, bias = bn_eval_terms(bn)
    return (x - mean) * mul + bias


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
               unbiased_update: bool = False) -> torch.Tensor:
    """Train-mode BatchNorm over the last (channel) axis of x: normalise by
    the biased batch statistics over every other axis, in flax's order
    (x - mean) * (rsqrt(var + eps) * scale) + bias, and update the running
    statistics with momentum 0.1.

    The variance is taken in two passes, mean((x - mean)^2), as the
    reference's torch takes it; flax takes E[x^2] - E[x]^2, which loses
    digits where a channel's mean^2 is large against its variance.  The
    running variance takes the biased batch variance, as flax's ``nn.BatchNorm``
    stores it, unless ``unbiased_update``: then v * n / (n - 1), as the JAX
    package's edge convs store it (``models/dgcnn.py:107-110`` there) and
    torch's BatchNorm always does.  Under a data-parallel context
    (``parallel.data_parallel``) both passes are all-reduced sums over the
    global batch and n counts its rows, as the JAX package's step sharded
    over a mesh takes them.
    """
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    dp = data_parallel.active()
    if dp is None:
        mean = x.mean(dim=dims)
        xc = x - mean
        var = xc.square().mean(dim=dims)
    else:                   # the same two passes over the global batch
        n *= dp.world
        mean = dp.all_reduce(x.sum(dim=dims)) / n
        xc = x - mean
        var = dp.all_reduce(xc.square().sum(dim=dims)) / n
    with torch.no_grad():
        update = var * (n / max(n - 1, 1)) if unbiased_update else var
        bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * update)
        bn.num_batches_tracked.add_(1)
    return xc * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias


def bn_apply(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
             unbiased_update: bool = False) -> torch.Tensor:
    """BatchNorm over the last axis in the module's mode: ``batch_norm`` in
    training, ``bn_eval`` otherwise."""
    if bn.training:
        return batch_norm(x, bn, unbiased_update)
    return bn_eval(x, bn)


class Dropout(nn.Module):
    """Dropout that holds no state and draws its mask from the generator it
    is given, never from torch's or numpy's global stream: in training each
    value is kept with probability 1 - p and scaled by 1 / (1 - p); in eval,
    or at p = 0, the input passes unchanged (the reference's ``nn.Dropout``
    in both).  Under a data-parallel context the mask is drawn for the
    global batch, from a generator seeded alike on every rank, and each
    rank keeps its rows: the mask of the single-process step."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("a Dropout in training needs a torch.Generator "
                             "(pass generator=...), or call .eval() on it")
        keep = 1.0 - self.p
        dp = data_parallel.active()
        if dp is None:
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        else:               # the global batch's mask, this rank's rows
            mask = torch.rand((dp.global_batch, *x.shape[1:]),
                              generator=generator,
                              device=x.device)[dp.rows(x.shape[0])] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


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
    """relu(bn(conv(x))) over the channel axis of a channels-last tensor,
    with the BatchNorm in its module's mode (``bn_apply``)."""
    return torch.relu(bn_apply(pointwise(x, conv), bn))


def mlp_stack(x: torch.Tensor, convs, bns) -> torch.Tensor:
    """A per-point MLP of ConvBN + ReLU layers (the JAX ``MLPStack``),
    un-fused, each BatchNorm in its module's mode."""
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


def resolve_device(name: str) -> torch.device:
    """The torch device for a config's ``device``.  Asking for CUDA on a
    machine without it raises; nothing continues on the CPU."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                               "available; pass --device cpu to run on the CPU")
        set_matmul_precision()
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")
