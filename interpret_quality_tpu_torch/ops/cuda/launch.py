"""What every kernel wrapper shares: the device rule, argument checks, the
caller's stream, the launcher's error code, and the launch registry."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

P = ctypes.c_void_p     # a pointer or the stream (a Python int)
I = ctypes.c_int
F = ctypes.c_float

# The kernels a wrapper launches, listed once
KERNELS = ("knn", "gather_extrema", "knn_gather_extrema", "fps",
           "fused_ball_mlp3", "knn_with_density", "fused_pointconv_sa",
           "gather_rows", "dense_pool", "knn_group_max", "group_res_mlp")
# The settings a kernel runs at, by the code its launcher takes; code 0 is
# the exact setting.  The sel argument of iq_knn, iq_knn_gather_extrema and
# iq_knn_density, by selection class (kSel* in knn_select.cuh); the prec
# argument of iq_ball_mlp3, iq_pointconv_sa, iq_dense_pool,
# iq_knn_group_max and iq_group_res_mlp (kPrec* in mma_tf32.cuh); the bf16
# argument of iq_gather_extrema and iq_gather_rows.
SELECT_CODES = {"exact": 0, "packed": 1, "bf16": 2}
PRECISION_CODES = {"highest": 0, "high": 1, "default": 2}
GATHER_CODES = {"f32": 0, "bf16": 1}
SETTINGS = {"knn": SELECT_CODES, "knn_gather_extrema": SELECT_CODES,
            "knn_with_density": SELECT_CODES,
            "fused_ball_mlp3": PRECISION_CODES,
            "fused_pointconv_sa": PRECISION_CODES,
            "dense_pool": PRECISION_CODES,
            "knn_group_max": PRECISION_CODES,
            "group_res_mlp": PRECISION_CODES,
            "gather_extrema": GATHER_CODES, "gather_rows": GATHER_CODES}
# The launch registry: the launches of each kernel since the last
# reset_launches(), and under "<kernel>:<setting>" those at each setting
# other than the exact one, counted under the kernel's name as well
LAUNCHES = dict.fromkeys(KERNELS + tuple(
    f"{kernel}:{setting}" for kernel, codes in SETTINGS.items()
    for setting, code in codes.items() if code), 0)


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


def count_launch(kernel: str, setting: Optional[str] = None) -> None:
    """Count one launch of ``kernel``, and of the ``setting`` it ran at
    unless that is None or the exact one.  A kernel or setting the registry
    does not know raises before anything is counted."""
    routed = setting is not None and SETTINGS[kernel][setting] != 0
    LAUNCHES[kernel] += 1
    if routed:
        LAUNCHES[f"{kernel}:{setting}"] += 1


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launches(*keys: str, since: Optional[dict] = None) -> dict:
    """The counts of ``keys`` (kernels or "<kernel>:<setting>"), by default of
    the eleven kernels; with ``since``, an earlier reading, those made since
    it."""
    since = since or {}
    return {key: LAUNCHES[key] - since.get(key, 0) for key in keys or KERNELS}
