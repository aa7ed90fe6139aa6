"""ctypes binding for the native host library (``native/iqtpu_host.cpp``),
the port's copy of ``interpret_quality_tpu/data/native.py``.

These host routines cover the data path the reference implements in pure
Python/numpy; none of them lies on a kernel path:

* ``parse_pts`` — whitespace-float parsing of ShapeNet ``.pts`` files
  (reference final_data_train.py:233 / final_data_shapley.py:152 use
  ``np.loadtxt``).
* ``fps`` — farthest-point sampling with the first point fixed at index 0
  (reference final_data_shapley.py:71-92, a Python loop per cloud).
* ``region_assign`` — nearest-FPS-centre region id per point (reference
  final_shapley_value.py:20-35).

Every entry point has a pure-numpy fallback, so the package works without
the compiled library; ``build/libiqtpu_host.so`` is loaded when present
(``scripts/build_native.sh`` builds it).  ``IQTPU_NO_NATIVE=1`` forces the
numpy path.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_PKG_ROOT, "build", "libiqtpu_host.so")

_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("IQTPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.iqtpu_fps_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.iqtpu_fps_f32.restype = None
    lib.iqtpu_fps_batch_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
    lib.iqtpu_fps_batch_f32.restype = None
    lib.iqtpu_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p,
                                       ctypes.c_int64]
    lib.iqtpu_parse_floats.restype = ctypes.c_int64
    lib.iqtpu_region_assign_f32.argtypes = [f32p, ctypes.c_int64, f32p,
                                            ctypes.c_int64, i32p]
    lib.iqtpu_region_assign_f32.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """True when the compiled library is loadable (and not disabled)."""
    return _load_lib() is not None


# ---------------------------------------------------------------------------
# .pts parsing
# ---------------------------------------------------------------------------
def parse_pts(path: str, cols: int = 3) -> np.ndarray:
    """Read a whitespace-separated float text file as an (n, cols) float32
    array, keeping the first ``cols`` columns of each row (ShapeNet ``.pts``
    rows are ``x y z``; some variants append normals).

    Matches ``np.loadtxt(path).astype(float32)[:, :cols]`` for well-formed
    files (reference final_data_shapley.py:152).
    """
    lib = _load_lib()
    with open(path, "rb") as f:
        buf = f.read()
    if lib is None:
        vals = np.array(buf.decode().split(), dtype=np.float32)
    else:
        max_vals = len(buf) // 2 + 16  # a float needs >=2 bytes ("1 ")
        out = np.empty((max_vals,), dtype=np.float32)
        n = lib.iqtpu_parse_floats(
            buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_vals)
        vals = out[:n]
    ncols_in = _infer_cols(buf, len(vals))
    rows = len(vals) // ncols_in
    return np.ascontiguousarray(
        vals[:rows * ncols_in].reshape(rows, ncols_in)[:, :cols])


def _infer_cols(buf: bytes, nvals: int) -> int:
    """Infer the column count from the first non-empty line."""
    for line in buf.split(b"\n"):
        parts = line.split()
        if parts:
            return max(1, len(parts))
    return 3 if nvals % 3 == 0 or nvals == 0 else 1


# ---------------------------------------------------------------------------
# Farthest-point sampling
# ---------------------------------------------------------------------------
def fps(points: np.ndarray, npoint: int) -> np.ndarray:
    """FPS indices with the first point fixed at 0, bit-identical to the
    reference's numpy loop (final_data_shapley.py:71-92)."""
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    lib = _load_lib()
    if lib is None:
        return _fps_np(pts, npoint)
    out = np.empty((npoint,), dtype=np.int64)
    lib.iqtpu_fps_f32(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0], npoint,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def fps_batch(points: np.ndarray, npoint: int) -> np.ndarray:
    """Batched FPS: (b, n, 3) -> (b, npoint) indices."""
    pts = np.ascontiguousarray(points[..., :3], dtype=np.float32)
    b, n = pts.shape[0], pts.shape[1]
    lib = _load_lib()
    if lib is None:
        return np.stack([_fps_np(pts[i], npoint) for i in range(b)])
    out = np.empty((b, npoint), dtype=np.int64)
    lib.iqtpu_fps_batch_f32(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, n, npoint,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def _fps_np(xyz: np.ndarray, npoint: int) -> np.ndarray:
    N = xyz.shape[0]
    centroids = np.zeros((npoint,), dtype=np.int64)
    distance = np.full((N,), 1e10, dtype=np.float64)
    farthest = 0
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest, :]) ** 2, -1)
        mask = dist < distance
        distance[mask] = dist[mask]
        farthest = int(np.argmax(distance, -1))
    return centroids


# ---------------------------------------------------------------------------
# Region assignment
# ---------------------------------------------------------------------------
def region_assign(points: np.ndarray, centres: np.ndarray) -> np.ndarray:
    """Nearest-centre index per point: (n,3),(r,3) -> (n,) int32
    (reference final_shapley_value.py:20-35 argmin semantics)."""
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    ctr = np.ascontiguousarray(centres[:, :3], dtype=np.float32)
    lib = _load_lib()
    if lib is None:
        d = ((pts[:, None, :] - ctr[None, :, :]) ** 2).sum(-1)
        return d.argmin(axis=1).astype(np.int32)
    out = np.empty((pts.shape[0],), dtype=np.int32)
    lib.iqtpu_region_assign_f32(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        ctr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctr.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
