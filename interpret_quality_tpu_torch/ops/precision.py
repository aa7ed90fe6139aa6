"""The JAX package's precision settings as the port computes them: the
products of ``--matmul_precision``, the gathered values of
``--gather_precision`` and the kNN selection keys of ``IQTPU_KNN_SELECT``.

Both settings are process-global (``config``) and govern the card only.
On the CPU every product is f32 and every gather exact, as the JAX package
computes there (XLA:CPU ignores the matmul precision, and its CPU path
never reaches the kernels whose values the gather setting splits).

Products (``matmul``; ``models/common.py`` lists which products follow the
setting and which stay f32):

  ``highest`` (the port's default) f32, cuBLAS with TF32 off, the
  reference's numerics; ``high`` one TF32 product (cuBLAS's own TF32,
  torch's ``high``: coarser than the TPU's three bf16 passes);
  ``default`` both operands rounded to bf16, to nearest even, then one
  TF32 product with f32 accumulation, which is exact for bf16 operands:
  one bf16 pass, as the TPU's default.  A float64 product is exact at
  every setting.  ``matmul`` is differentiable: its backward products (the
  gradient against the other operand) take the same setting, as
  ``jax.grad`` of a dot keeps its precision, so training and the
  smoothness step see the setting too.

Gathers (``gather_values``): at 2 value parts (``hilo``) the f32 values
exactly, at 1 (``bf16``) each value rounded to bf16, to nearest even, which
is what the TPU kernels' one bf16 plane copies through a one-hot product.

kNN selection (``selection_keys``, ``knn_class``): each class of
``config.KNN_SELECT_CLASSES`` selects the k smallest keys made from the f32
distances, ties to the lowest index; a wrapper's ``select=None`` is the
process's setting on the card and the exact one on the CPU (the JAX
package's CPU path is XLA's ``top_k``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import config
from ..utils import profiling


def set_matmul_precision(precision: Optional[str] = None) -> None:
    """Set the process's matmul precision (None keeps it) and the card's
    f32 flags: cuBLAS and cuDNN never take TF32 by themselves (``matmul``
    takes it for one product where the setting asks)."""
    if precision is not None:
        config.set_matmul_precision(precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Each value rounded to bf16 (7 mantissa bits), to nearest even, as
    ``astype(jnp.bfloat16)`` rounds it, and returned in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def value_parts(parts: Optional[int], cpu: bool) -> int:
    """The value planes a gather reads: the caller's ``parts`` where it
    names one; else on the card the process's ``--gather_precision``
    (``config.gather_value_parts``), and on the CPU 2, exact f32."""
    if parts is not None:
        if parts not in (1, 2):
            raise ValueError(f"parts must be 1 or 2, got {parts!r}")
        return parts
    return 2 if cpu else config.gather_value_parts()


def gather_values(a: torch.Tensor, parts: int) -> torch.Tensor:
    """The values a gather reads at ``parts`` value planes: ``a`` itself at
    2, each value rounded to bf16 (``round_bf16``) at 1."""
    if parts == 2:
        return a
    if parts == 1:
        return round_bf16(a)
    raise ValueError(f"parts must be 1 or 2, got {parts!r}")


def selection_keys(dist: torch.Tensor, cls: str) -> torch.Tensor:
    """The keys a kNN selection of class ``cls`` orders f32 distances
    (..., N) by, N the database rows: ``exact`` the distances; ``packed``
    each distance's bits with negatives clamped to +0 and the low
    b = (N - 1).bit_length() bits cleared (the JAX package's int32 key
    ``(bits & ~mask) | col`` orders as this key, then the column);
    ``bf16`` each distance rounded to bf16, to nearest even."""
    if cls == "exact":
        return dist
    if cls == "bf16":
        return round_bf16(dist)
    if cls != "packed":
        raise ValueError(f"unknown selection class {cls!r}")
    if dist.dtype != torch.float32:
        raise ValueError(f"packed keys take float32 distances, got {dist.dtype}")
    mask = (1 << (dist.shape[-1] - 1).bit_length()) - 1
    bits = dist.contiguous().view(torch.int32)
    return (torch.where(bits < 0, 0, bits) & ~mask).view(torch.float32)


def knn_class(select: Optional[str], cpu: bool, kernel: str = "knn",
              layout: Optional[str] = None) -> str:
    """The selection class (``config.knn_select_class``) the kNN wrapper
    ``kernel`` runs at: that of the caller's ``select`` where it names one,
    at ``layout`` or else the process's layout; else on the card that of
    the process's settings (``config.knn_select``, ``config.knn_layout``),
    and on the CPU the exact class.  A bad name raises on either device,
    the process's too."""
    if layout is None:
        layout = config.knn_layout()
    if select is None:
        select = config.knn_select()
        if cpu:
            return "exact"
    return config.knn_select_class(select, layout, kernel)


def _sum_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum a broadcast gradient back to an operand's shape."""
    lead = t.dim() - len(shape)
    if lead > 0:
        t = t.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


class PrecisionMatmul(torch.autograd.Function):
    """x @ w (``torch.matmul`` broadcasting, both at least 2-d) whose
    float32 products, forward and backward, are ``product``'s; products of
    any other dtype are exact ``torch.matmul``.  The backward products are
    grad @ w^T and x^T @ grad, each summed to its operand's shape."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                product: Callable) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.product = product
        return _product(product, x, w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _sum_to(_product(ctx.product, grad, w.transpose(-1, -2)),
                         x.shape)
        if ctx.needs_input_grad[1]:
            if w.dim() == 2:        # one product over every row of the batch
                gw = _product(ctx.product,
                              x.reshape(-1, x.shape[-1]).transpose(0, 1),
                              grad.reshape(-1, grad.shape[-1]))
            else:
                gw = _sum_to(_product(ctx.product, x.transpose(-1, -2), grad),
                             w.shape)
        return gx, gw, None


def _product(product: Callable, a: torch.Tensor, b: torch.Tensor):
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return product(a, b)
    return torch.matmul(a, b)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product through cuBLAS (torch's ``high``).  torch has no
    per-call TF32 switch: the process's flag is set for this product and
    restored after it."""
    flags = torch.backends.cuda.matmul
    allowed = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = allowed


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 pass: the operands rounded to bf16, one TF32 product (exact
    for bf16 operands), f32 accumulation."""
    return _tf32_matmul(round_bf16(a), round_bf16(b))


CARD_PRODUCTS = {"high": _tf32_matmul, "default": _bf16_matmul}


# the work counter of ``matmul`` (``utils.profiling.count``)
DENSE_PRODUCTS = "dense_products"


def product_operations(x: torch.Tensor, w: torch.Tensor) -> int:
    """Operations of the product x @ w (``torch.matmul`` broadcasting), 2 a
    multiply-add, from the shapes alone: 2 x rows x in x out, the rows
    every leading index of the broadcast result."""
    rows = x.shape[-2] if x.dim() > 1 else 1
    cols = w.shape[-1] if w.dim() > 1 else 1
    batch = torch.broadcast_shapes(x.shape[:-2], w.shape[:-2])
    return 2 * batch.numel() * rows * x.shape[-1] * cols


def matmul(x: torch.Tensor, w: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    """x @ w at ``precision`` (None: ``config.matmul_precision()``) on the
    card; f32 on the CPU and at ``highest``, where it is ``torch.matmul``
    itself.  Differentiable in both operands.  While a profiler records,
    the forward product's operations (``product_operations``) count in
    ``DENSE_PRODUCTS``."""
    if profiling.tracing():
        profiling.count(DENSE_PRODUCTS, product_operations(x, w))
    if precision is None:
        precision = config.matmul_precision()
    elif precision not in config.MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    if precision == "highest" or x.device.type != "cuda":
        return torch.matmul(x, w)
    return PrecisionMatmul.apply(x, w, CARD_PRODUCTS[precision])
