"""Farthest-point sampling, hand-written in CUDA C++ for Hopper
(``csrc/fps.cu``), with its plain PyTorch version.

``fps`` replaces ``interpret_quality_tpu/ops/pallas/fps.py`` ``fps_pallas``
/ ``_fps_kernel``.  It takes its plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  Each launch counts in
the launch registry (``launch.count_launch``) and runs inside a profiler
span named ``iq_fps``.

The kernel keeps a cloud of up to ``REGISTER_ROUTE_MAX_N`` points in
registers (a block of 128 threads per cloud, 1, 2, 4 or 8 points a thread,
one barrier a step); a larger cloud takes the generic kernel, which keeps it
in shared memory (up to ``MAX_N`` points).  Both are bit-equal to
``fps_plain``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from ..geometry import farthest_point_sample
from . import build
from .launch import I, P, check, count_launch, on_cpu, raise_on, stream

REGISTER_ROUTE_MAX_N = 1024   # 128 threads x 8 points (kRegThreads * kMaxPpt)
MAX_N = 14528                 # the generic route: 4 N floats of shared memory


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fps")
    lib.iq_fps.argtypes = [P, P, I, I, I, P]
    lib.iq_fps.restype = ctypes.c_int
    lib.iq_fps_occupancy.argtypes = [I, P]
    lib.iq_fps_occupancy.restype = ctypes.c_int
    return lib


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of ``fps``: ``ops.geometry.farthest_point_sample``."""
    return farthest_point_sample(xyz, npoint)


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling, first index 0, argmax ties to the lowest
    index, f32 distances rounded as the plain version rounds them (the
    kernel is bit-equal to it).

    Args:
      xyz: (B, N, 3) float32.
    Returns:
      (B, npoint) int32; npoint > N keeps going as the plain version does.
    """
    if on_cpu(xyz):
        return fps_plain(xyz, npoint)
    check(xyz, "xyz", torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3 or npoint < 1 or not 1 <= N <= MAX_N:
        raise ValueError(f"xyz {tuple(xyz.shape)} must be (B, N, 3) with N in "
                         f"[1, {MAX_N}] and npoint={npoint} positive")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    with record_function("iq_fps"):
        rc = _lib().iq_fps(xyz.data_ptr(), out.data_ptr(), B, N, npoint,
                           stream(xyz))
    raise_on(rc, "iq_fps")
    count_launch("fps")
    return out


def fps_occupancy(N: int) -> dict:
    """Which route the kernel takes for clouds of N points and how many of
    its blocks (one per cloud) the current card holds at once: what
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` says of the built
    kernel.  Launches nothing."""
    info = (ctypes.c_int * 4)()
    raise_on(_lib().iq_fps_occupancy(N, info), "iq_fps_occupancy")
    ppt, threads, blocks, sms = info
    return {"route": "registers" if ppt else "shared memory",
            "points_per_thread": ppt, "threads": threads,
            "blocks_per_sm": blocks, "resident_clouds": blocks * sms}
