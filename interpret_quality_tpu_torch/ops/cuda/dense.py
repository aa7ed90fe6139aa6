"""DGCNN's head in one kernel, hand-written in CUDA C++ for Hopper
(``csrc/dense.cu``), with its plain PyTorch version.

==========================  ==============================================
wrapper                     replaces (interpret_quality_tpu/ops/pallas/)
==========================  ==============================================
``dense_pool``              none: the JAX package leaves the head to XLA,
                            which fuses it on the TPU
==========================  ==============================================

``dense_pool`` is the eval head of the edge-conv family after its four
edge convs: conv5 (a 1x1 conv without bias) over the concatenated edge
outputs, its eval BatchNorm and LeakyReLU(0.2), then the max and the mean
over each cloud's points, concatenated (the input of ``linear1``).  The
kernel reads the edge outputs where they lie and keeps the (B, N, C)
activation out of device memory; its product runs on the tensor cores at
the process's ``--matmul_precision`` (``config.matmul_precision``): at
``highest`` as three TF32 products that keep f32 accuracy, at ``high`` as
one product of TF32-rounded operands, at ``default`` as one product of
bf16-rounded operands (``ops/cuda/emulation.py`` ``matmul_at`` repeats
each).  On the CPU the plain version computes today's arithmetic
(``ops.precision.matmul``, f32 at every setting there).

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
counts in the launch registry (``launch.count_launch``) under
``"dense_pool"``, and at a setting other than ``highest`` under
``"dense_pool:<setting>"`` as well, and runs inside
the profiler span ``iq_dense_pool``; while a profiler records, its products
(2 x B x N x in x out) count in the work counter ``dense_products``, as
``ops.precision.matmul`` counts the products it runs.

A masked coalition collapses its absent regions onto one point, so about
half of a batch's rows repeat an earlier row of their cloud.  Given each
cloud's distinct rows and their copies (``lists``: kernel 3's copy lists,
``neighbors.knn_gather_extrema(..., copy_lists=True)``), the kernel walks
the distinct rows only (its listed route): the max takes each once, the
mean weighs each by its copies and still divides by N.  The max is the
every-row walk's bit for bit; the mean sums in another grouping.  The
products it then counts are 2 x (distinct rows) x in x out, added on the
device from the lists' counts.  ``emulation.dense_pool_listed`` is the
listed walk's plain model.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from ... import config
from ...utils import profiling
from ..precision import DENSE_PRODUCTS, matmul
from . import build
from .launch import (PRECISION_CODES, I, P, check, count_launch, on_cpu,
                     raise_on, stream)
from .neighbors import DistinctRows

MAX_SEGMENTS = 4     # feature segments the kernel reads (kMaxSegments)
SEGMENT_QUANTUM = 32  # each segment's width a multiple of it (kKChunk)
COLUMN_QUANTUM = 256  # the output width a multiple of it (kCols)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("dense")
    lib.iq_dense_pool.argtypes = [P] * 4 + [I] * 4 + [P] * 9 + [I] * 4 + [P]
    lib.iq_dense_pool.restype = ctypes.c_int
    return lib


def _check_args(feats: Sequence[torch.Tensor], conv: nn.Module,
                bn: nn.Module) -> None:
    """What both versions take: (B, N, C_i) segments of one cloud batch in
    conv's floating dtype whose widths sum to conv's input width, a conv
    without bias, and an eval BatchNorm of conv's output width."""
    if not 1 <= len(feats) <= MAX_SEGMENTS:
        raise ValueError(f"expected 1 to {MAX_SEGMENTS} feature segments, got "
                         f"{len(feats)}")
    w = conv.weight
    if not w.is_floating_point() or w.dim() < 2 or w.shape[2:].numel() != 1:
        raise ValueError(f"conv.weight: expected a floating 1x1 conv weight, "
                         f"got {w.dtype} {tuple(w.shape)}")
    B, N = feats[0].shape[:2]
    for i, f in enumerate(feats):
        if f.dtype != w.dtype or f.dim() != 3 or f.shape[:2] != (B, N):
            raise ValueError(f"feats[{i}]: expected {w.dtype} ({B}, {N}, C), "
                             f"got {f.dtype} {tuple(f.shape)}")
    if N < 1:
        raise ValueError("feats: expected at least one point a cloud")
    if conv.bias is not None:
        raise ValueError("conv: the head's conv has no bias")
    widths = [f.shape[2] for f in feats]
    if sum(widths) != w.shape[1]:
        raise ValueError(f"segment widths {widths} sum to {sum(widths)}, not "
                         f"conv's input width {w.shape[1]}")
    if bn.training or bn.num_features != w.shape[0]:
        raise ValueError(f"bn: expected an eval BatchNorm of {w.shape[0]} "
                         f"features, got {bn.num_features} "
                         f"(training={bn.training})")


def _check_lists(lists: DistinctRows, B: int, N: int, device) -> None:
    """The listed route's lists: int32 rows (B, N), nrows (B,) and
    starts (B, N + 1) on the features' device, each contiguous (views of
    kernel 3's scratch).  Their values are the caller's contract: nrows in
    [1, N], rows ascending in [0, N), the copies' spans summing to N."""
    for t, name, shape in zip(lists, DistinctRows._fields,
                              ((B, N), (B,), (B, N + 1))):
        check(t, f"lists.{name}", torch.int32, len(shape))
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"lists.{name}: expected {shape} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def dense_pool_plain(feats: Sequence[torch.Tensor], conv: nn.Module,
                     bn: nn.Module, product=matmul) -> torch.Tensor:
    """Plain version of ``dense_pool``: the concatenation, conv5 by
    ``product`` (``ops.precision.matmul``: the model's own; the checks pass
    ``emulation.matmul_at``), eval BatchNorm, LeakyReLU, max and mean over
    the points, concatenated."""
    # importing models.common imports the models, and DGCNN this module
    from ...models.common import bn_eval, leaky_relu02
    h = torch.cat(list(feats), dim=-1)                          # (B, N, K)
    w = conv.weight.reshape(conv.weight.shape[0], -1)           # (C, K)
    h = leaky_relu02(bn_eval(product(h, w.T), bn))
    return torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)   # (B, 2C)


def dense_pool(feats: Sequence[torch.Tensor], conv: nn.Module,
               bn: nn.Module,
               lists: Optional[DistinctRows] = None) -> torch.Tensor:
    """The edge-conv family's eval head: out[b, c] = max_n y[b, n, c] and
    out[b, C + c] = mean_n y[b, n, c] with
    y = leaky_relu_0.2(bn_eval(cat(feats) @ W^T)).

    Args:
      feats: 1 to 4 (B, N, C_i) segments (DGCNN's four edge-conv outputs)
        in conv's dtype, their widths summing to conv's input width.
      conv: conv5 (Conv1d(K, C, 1) without bias); bn: its eval BatchNorm.
      lists: each cloud's distinct rows and their copies, rows equal bit
        for bit in every segment (``neighbors.DistinctRows``, on the card);
        None walks every row.
    Returns:
      (B, 2C) in conv's dtype.

    On CUDA tensors the kernel takes float32 segments of widths that are
    multiples of 32, on a 16-byte boundary, and C a multiple of 256; at
    ``highest`` its result is within f32 rounding of the plain version (the
    split products and another order of the sums), not bit-equal.
    """
    _check_args(feats, conv, bn)
    if on_cpu(*feats, conv.weight):
        if lists is not None:
            raise ValueError("lists: the plain version walks every row")
        return dense_pool_plain(feats, conv, bn)
    from ...models.common import bn_eval_terms
    precision = config.matmul_precision()
    B, N = feats[0].shape[:2]
    C, K = conv.weight.shape[:2]
    for i, f in enumerate(feats):
        check(f, f"feats[{i}]", torch.float32, 3)
        if f.shape[2] % SEGMENT_QUANTUM or f.data_ptr() % 16:
            raise ValueError(f"feats[{i}]: the kernel takes widths that are "
                             f"multiples of {SEGMENT_QUANTUM} on a 16-byte "
                             f"boundary, got {f.shape[2]} at "
                             f"{f.data_ptr() % 16} past one")
    if lists is not None:
        _check_lists(lists, B, N, conv.weight.device)
    if C % COLUMN_QUANTUM:
        raise ValueError(f"conv: the kernel takes an output width that is a "
                         f"multiple of {COLUMN_QUANTUM}, got {C}")
    w = conv.weight.detach().reshape(C, K).contiguous()
    if any(t.device != w.device or t.dtype != torch.float32 for t in
           (bn.running_mean, bn.running_var, bn.weight, bn.bias)):
        raise ValueError("bn: expected float32 statistics and parameters on "
                         "the features' device")
    params = [t.detach().contiguous() for t in bn_eval_terms(bn)]
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_SEGMENTS - len(feats))
    widths = [f.shape[2] for f in feats] + [0] * (MAX_SEGMENTS - len(feats))
    out = torch.empty((B, 2 * C), dtype=torch.float32, device=w.device)
    # the weights in the order the kernel's fragments read them
    scratch = torch.empty(w.numel(), dtype=torch.float32, device=w.device)
    if lists is None:
        profiling.count(DENSE_PRODUCTS, 2 * B * N * K * C)
    with record_function("iq_dense_pool"):
        rc = _lib().iq_dense_pool(
            *ptrs, *widths, w.data_ptr(), *[t.data_ptr() for t in params],
            out.data_ptr(), scratch.data_ptr(),
            *([None] * 3 if lists is None else [t.data_ptr() for t in lists]),
            B, N, C, PRECISION_CODES[precision], stream(w))
    raise_on(rc, "iq_dense_pool")
    if lists is not None and profiling.tracing():   # after the span
        profiling.accumulator(DENSE_PRODUCTS, w.device).add_(
            lists.nrows.sum(dtype=torch.int64) * (2 * K * C))
    count_launch("dense_pool", precision)
    return out
