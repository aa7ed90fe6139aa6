"""PointMLP's grouped residual chain in one kernel, hand-written in CUDA C++
for Hopper (``csrc/group_mlp.cu``), with its plain PyTorch version.

==========================  ==============================================
wrapper                     replaces (interpret_quality_tpu/ops/pallas/)
==========================  ==============================================
``group_res_mlp``           none: the JAX package has no PointMLP; added
                            as kernel 11 because the plain stage writes
                            several (B, S, 24, C) tensors of 10.4 GB each
                            at a forward of 1650 clouds
==========================  ==============================================

``group_res_mlp`` is what a PointMLP stage does on its groups after the
kNN and the per-cloud standard deviation (``models/pointmlp.py``): the
transfer layer hoisted above the gather, its ReLU, two residual blocks and
the max over each centre's slots.  For cloud b, centre s and column o,

    h0[b, s, j] = relu(sig[b] * (u[b, idx[b, s, j]] - u[b, fps[b, s]])
                       + c[b, s])
    R(x)        = relu(relu(x @ a1 + b1) @ a2 + b2 + x)
    out[b, s, o] = max_j R_2(R_1(h0[b, s, j]))[o]

with sig[b] = 1 / (std_b + 1e-5) and every BatchNorm folded into its
(a, b).  The centre's own row fps[b, s] is taken off before the scale: a
term -sig u[fps] folded into c would leave c only rounding where sigma_b is
near 0 (a cloud collapsed to one point has sig = 1e5).  Nothing of size
(B, S, K, C) reaches device memory.  The four products run on the tensor
cores at the process's ``--matmul_precision``
(``config.matmul_precision``): at ``highest`` as three TF32 products that
keep f32 accuracy, at ``high`` as one product of TF32-rounded operands, at
``default`` as one product of bf16-rounded operands (``emulation.
group_res_mlp_at`` repeats each).  The gathered u rows are exact f32 unless
``parts`` (``--gather_precision``) is 1: then each is rounded to bf16, as
the other kernels' gathered rows are.  On the CPU the plain version
computes f32 products at every setting.

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
counts in the launch registry (``launch.count_launch``) under
``"group_res_mlp"`` (and ``"group_res_mlp:<setting>"`` at a setting other
than ``highest``) and runs inside the profiler span ``iq_group_res_mlp``;
while a profiler records, the (centre, slot) rows it runs through the four
products, B x S x K a launch, count in the work counter ``K11_SLOTS``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ... import config
from ...utils import profiling
from ..geometry import index_points
from ..precision import gather_values, value_parts
from . import build
from .launch import (PRECISION_CODES, I, P, check, count_launch, on_cpu,
                     raise_on, stream)

# the work counter of group_res_mlp (``utils.profiling.count``): the
# (centre, slot) rows the kernel runs through its four products, every
# centre counted, repeated ones too, the pads of a ragged last tile left out
K11_SLOTS = "k11_slots"

SLOTS = 24                         # neighbours of a centre the kernel takes (kRSlots)
WIDTHS = (128, 256, 512, 1024)     # the widths it is instantiated for
TILE_ROWS = 48                     # rows of a tile (kRRows): its scratch is 2 x 48 x C a block

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("group_mlp")
    lib.iq_group_res_mlp.argtypes = [P] * 9 + [I] * 7 + [P]
    lib.iq_group_res_mlp.restype = ctypes.c_int
    lib.iq_group_res_mlp_capacity.argtypes = [I, I, P]
    lib.iq_group_res_mlp_capacity.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def capacity(C: int, code: int, device: int) -> int:
    """The blocks of width C at precision code that fit on card ``device``
    at once: the launch's grid and the scratch's block count."""
    with torch.cuda.device(device):
        n = ctypes.c_int(0)
        raise_on(_lib().iq_group_res_mlp_capacity(C, code, ctypes.addressof(n)),
                 "iq_group_res_mlp_capacity")
    return n.value


def group_res_mlp_plain(idx: torch.Tensor, fps: torch.Tensor,
                        u: torch.Tensor, c: torch.Tensor, sig: torch.Tensor,
                        blocks: Sequence[Block], parts: int = 2,
                        product: Callable = torch.matmul) -> torch.Tensor:
    """Plain version of ``group_res_mlp``: the rows of u (at ``parts``
    value planes) gathered into a (B, S, K, C) tensor, h0, each residual
    block's two products by ``product`` (``emulation.group_res_mlp_at``
    passes the kernel's) and the max over the slots."""
    u = gather_values(u, parts)
    d = index_points(u, idx) - index_points(u, fps)[:, :, None, :]
    h = torch.relu(d * sig[:, None, None, None] + c[:, :, None, :])
    for a1, b1, a2, b2 in blocks:
        x = h
        h = torch.relu(product(h, a1) + b1)
        h = torch.relu(product(h, a2) + b2 + x)
    return h.amax(dim=2)


def group_res_mlp(idx: torch.Tensor, fps: torch.Tensor, u: torch.Tensor,
                  c: torch.Tensor, sig: torch.Tensor, blocks: Sequence[Block],
                  parts: Optional[int] = None) -> torch.Tensor:
    """One PointMLP stage's grouped layers after the kNN.

    Args:
      idx: (B, S, K) int32, each centre's neighbours among the N rows.
      fps: (B, S) int32, each centre's own row.
      u: (B, N, C) the transfer layer's hoisted rows (its BatchNorm's scale
        and the affine alpha folded in).
      c: (B, S, C) each centre's share: its features' product, the affine
        beta's and the BatchNorm's shift.
      sig: (B,) each cloud's 1 / (std + 1e-5).
      blocks: the two residual blocks, each (a1 (C, C), b1 (C,), a2, b2)
        with its BatchNorms folded in.
      parts: the value planes of the gathered u rows
        (``precision.value_parts``).
    Returns:
      (B, S, C) float32.

    Every index must lie in [0, N): the kernel does not check.  On CUDA
    tensors the kernel takes K = ``SLOTS``, two blocks and C in ``WIDTHS``
    (PointMLP's four stages), and anything else raises ``ValueError``; at
    ``highest`` its result is within rtol 1e-4 of the plain version, not
    bit-equal.
    """
    weights = [t for block in blocks for t in block]
    cpu = on_cpu(idx, fps, u, c, sig, *weights)
    parts = value_parts(parts, cpu)
    if cpu:
        return group_res_mlp_plain(idx, fps, u, c, sig, blocks, parts)
    precision = config.matmul_precision()
    check(idx, "idx", torch.int32, 3)
    check(fps, "fps", torch.int32, 2)
    check(u, "u", torch.float32, 3)
    check(c, "c", torch.float32, 3)
    B, S, K = idx.shape
    N, C = u.shape[1], u.shape[2]
    if (K != SLOTS or u.shape[0] != B or c.shape != (B, S, C)
            or fps.shape != (B, S) or sig.shape != (B,)):
        raise ValueError(f"idx {tuple(idx.shape)} (K must be {SLOTS}), fps "
                         f"{tuple(fps.shape)}, u {tuple(u.shape)}, c "
                         f"{tuple(c.shape)} and sig {tuple(sig.shape)} "
                         f"disagree")
    if C not in WIDTHS or len(blocks) != 2:
        raise ValueError(f"width {C} with {len(blocks)} blocks: C must be "
                         f"one of {WIDTHS}, with two residual blocks")
    if any(t.dtype != torch.float32 for t in weights + [sig]) or any(
            a.shape != (C, C) or b.shape != (C,)
            for block in blocks for a, b in (block[:2], block[2:])):
        raise ValueError(f"each block must be float32 ({C}, {C}) products "
                         f"and ({C},) shifts")
    a = torch.stack([t.detach() for t in weights[0::2]]).contiguous()
    bias = torch.stack([t.detach() for t in weights[1::2]]).contiguous()
    sig = sig.detach().contiguous()
    u = gather_values(u, parts)
    # the kernel reads rows of u and c as float4s
    u = u if u.data_ptr() % 16 == 0 else u.clone()
    c = c if c.data_ptr() % 16 == 0 else c.clone()
    out = torch.empty((B, S, C), dtype=torch.float32, device=u.device)
    code = PRECISION_CODES[precision]
    grid = capacity(C, code, u.device.index or 0)
    # the weights in the order the kernel streams them, then each block's
    # two activation buffers
    scratch = torch.empty(4 * C * C + grid * 2 * TILE_ROWS * C,
                          dtype=torch.float32, device=u.device)
    profiling.count(K11_SLOTS, B * S * K)
    with record_function("iq_group_res_mlp"):
        rc = _lib().iq_group_res_mlp(idx.data_ptr(), fps.data_ptr(),
                                     u.data_ptr(),
                                     c.data_ptr(), sig.data_ptr(),
                                     a.data_ptr(), bias.data_ptr(),
                                     out.data_ptr(), scratch.data_ptr(), grid,
                                     B, S, N, K, C, code, stream(u))
    raise_on(rc, "iq_group_res_mlp")
    count_launch("group_res_mlp", precision)
    return out
