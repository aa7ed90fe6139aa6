"""PCT's neighbour-embedding layer in one kernel, hand-written in CUDA C++
for Hopper (``csrc/knn_group.cu``), with its plain PyTorch version.

==========================  ==============================================
wrapper                     replaces (interpret_quality_tpu/ops/pallas/)
==========================  ==============================================
``knn_group_max``           none: the JAX package has no PCT; added as
                            kernel 10 because the plain layer writes a
                            (B, S, K, C) tensor of up to 13.8 GB a level
                            at a forward of 1650 clouds
==========================  ==============================================

``knn_group_max`` is one sample-and-group level of PCT (``gather_local_i``
of ``models/pct.py``) after its kNN, with layer 1 hoisted above the gather
and both BatchNorms folded: for each cloud b, centre s and output column o,

    out[b, s, o] = max_k relu(sum_c relu(u[b, idx[b, s, k], c] + c_s[b, s, c])
                              * a2[c, o] + b2[o])

Nothing of size (B, S, K, C) reaches device memory.  Layer 2's product runs
on the tensor cores at the process's ``--matmul_precision``
(``config.matmul_precision``): at ``highest`` as three TF32 products that
keep f32 accuracy, at ``high`` as one product of TF32-rounded operands, at
``default`` as one product of bf16-rounded operands (``emulation.
knn_group_max_at`` repeats each).  The gathered u rows are exact f32 unless
``parts`` (``--gather_precision``) is 1: then each is rounded to bf16, as
the other kernels' gathered feature rows are.  On the CPU the plain version
computes f32 products at every setting.

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
counts in the launch registry (``launch.count_launch``) under
``"knn_group_max"`` (and ``"knn_group_max:<setting>"`` at a setting other
than ``highest``) and runs inside the profiler span ``iq_knn_group_max``;
while a profiler records, the (centre, slot) rows it multiplies through
layer 2, B x S x K a launch, count in the work counter ``K10_SLOTS``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from ... import config
from ...utils import profiling
from ..geometry import index_points
from ..precision import gather_values, value_parts
from . import build
from .launch import (PRECISION_CODES, I, P, check, count_launch, on_cpu,
                     raise_on, stream)

# the work counter of knn_group_max (``utils.profiling.count``): the
# (centre, slot) rows the kernel multiplies through layer 2, every centre
# counted, repeated ones too, the pads of a ragged last tile left out
K10_SLOTS = "k10_slots"

SLOTS = 32                   # neighbours of a centre the kernel takes (kSlots)
OUTPUT_WIDTHS = (128, 256)   # layer 2's widths it is instantiated for
INPUT_QUANTUM = 32           # layer 1's width a multiple of it (kGKChunk)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("knn_group")
    lib.iq_knn_group_max.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.iq_knn_group_max.restype = ctypes.c_int
    return lib


def knn_group_max_plain(idx: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
                        a2: torch.Tensor, b2: torch.Tensor, parts: int = 2,
                        product: Callable = torch.matmul) -> torch.Tensor:
    """Plain version of ``knn_group_max``: the rows of u (at ``parts``
    value planes) gathered into a (B, S, K, C1) tensor, layer 1's ReLU,
    layer 2 by ``product`` (``emulation.knn_group_max_at`` passes the
    kernel's), its ReLU and the max over the slots."""
    h = torch.relu(index_points(gather_values(u, parts), idx)
                   + c[:, :, None, :])
    return torch.relu(product(h, a2) + b2).amax(dim=2)


def knn_group_max(idx: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
                  a2: torch.Tensor, b2: torch.Tensor,
                  parts: Optional[int] = None) -> torch.Tensor:
    """One PCT sample-and-group level after the kNN.

    Args:
      idx: (B, S, K) int32, each centre's neighbours among the N rows.
      u: (B, N, C1) layer 1's hoisted rows, f_j @ W1a^T with BatchNorm 1's
        scale folded in.
      c: (B, S, C1) each centre's share, f_c @ (W1b - W1a)^T, scaled and
        shifted by BatchNorm 1.
      a2: (C1, C2) layer 2 with BatchNorm 2's scale folded in; b2: (C2,)
        BatchNorm 2's shift.
      parts: the value planes of the gathered u rows
        (``precision.value_parts``).
    Returns:
      (B, S, C2) float32.

    Every index must lie in [0, N): the kernel does not check.  On CUDA
    tensors the kernel takes K = ``SLOTS``, C1 a multiple of 32 and C2 in
    ``OUTPUT_WIDTHS`` (PCT's (128, 128) and (256, 256)), and anything
    else raises ``ValueError``; at ``highest`` its result is within
    rtol 1e-4 / atol 1e-5 of the plain version, not bit-equal.
    """
    cpu = on_cpu(idx, u, c, a2, b2)
    parts = value_parts(parts, cpu)
    if cpu:
        return knn_group_max_plain(idx, u, c, a2, b2, parts)
    precision = config.matmul_precision()
    check(idx, "idx", torch.int32, 3)
    check(u, "u", torch.float32, 3)
    check(c, "c", torch.float32, 3)
    B, S, K = idx.shape
    N, C1 = u.shape[1], u.shape[2]
    if (K != SLOTS or u.shape[0] != B or c.shape != (B, S, C1)
            or a2.dim() != 2 or a2.shape[0] != C1):
        raise ValueError(f"idx {tuple(idx.shape)} (K must be {SLOTS}), u "
                         f"{tuple(u.shape)}, c {tuple(c.shape)} and a2 "
                         f"{tuple(a2.shape)} disagree")
    C2 = a2.shape[1]
    if C1 % INPUT_QUANTUM or C1 < 1 or C2 not in OUTPUT_WIDTHS:
        raise ValueError(f"layer widths ({C1}, {C2}): C1 must be a positive "
                         f"multiple of {INPUT_QUANTUM} and C2 one of "
                         f"{OUTPUT_WIDTHS}")
    if a2.dtype != torch.float32 or b2.dtype != torch.float32 \
            or b2.shape != (C2,):
        raise ValueError(f"a2 {a2.dtype} and b2 {b2.dtype} "
                         f"{tuple(b2.shape)}: expected float32, b2 ({C2},)")
    a2, b2 = a2.detach().contiguous(), b2.detach().contiguous()
    u = gather_values(u, parts)
    # the kernel reads rows of u and c as float4s
    u = u if u.data_ptr() % 16 == 0 else u.clone()
    c = c if c.data_ptr() % 16 == 0 else c.clone()
    out = torch.empty((B, S, C2), dtype=torch.float32, device=u.device)
    # layer 2's weights in the order the kernel's fragments read them
    scratch = torch.empty(C1 * C2, dtype=torch.float32, device=u.device)
    profiling.count(K10_SLOTS, B * S * K)
    with record_function("iq_knn_group_max"):
        rc = _lib().iq_knn_group_max(idx.data_ptr(), u.data_ptr(),
                                     c.data_ptr(), a2.data_ptr(),
                                     b2.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), B, S, N, K, C1, C2,
                                     PRECISION_CODES[precision], stream(u))
    raise_on(rc, "iq_knn_group_max")
    count_launch("knn_group_max", precision)
    return out
