"""What every kernel wrapper shares: the device rule, argument checks, the
caller's stream, and the launcher's error code."""
from __future__ import annotations

import ctypes

import torch

P = ctypes.c_void_p     # a pointer or the stream (a Python int)
I = ctypes.c_int
F = ctypes.c_float


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain version); False when all lie on one CUDA device (it launches its
    kernel).  Anything else raises: nothing falls back."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return False


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")
