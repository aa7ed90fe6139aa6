"""The edge-conv family's neighbour kernels, hand-written in CUDA C++ for
Hopper (``csrc/neighbors.cu``), with their plain PyTorch versions.

==========================  ==============================================
wrapper                     replaces (interpret_quality_tpu/ops/pallas/)
==========================  ==============================================
``knn``                     ``neighbors.py`` ``knn_pallas`` / ``_knn_kernel``
``gather_extrema``          ``neighbors.py`` ``gather_extrema`` /
                            ``_idx_extrema_kernel``
``knn_gather_extrema``      ``neighbors.py`` ``knn_gather_extrema`` /
                            ``_extrema_kernel``
==========================  ==============================================

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
counts in the launch registry (``launch.count_launch``), so a run can show
that its main path went through the kernels, and runs inside a profiler
span named after its launcher (``iq_knn``, ...), which a stage's
``--trace_dir`` trace shows.
``knn`` and ``knn_gather_extrema`` select for the
distinct query rows of a cloud only: a row that is a bit-for-bit copy of an
earlier one (a masked coalition's collapsed regions) takes that row's
result, which is what it would have selected.  ``knn`` has two routes,
chosen by shape alone (``knn_route``): the xyz route (the cloud staged
once a block, a warp per query) for clouds of at most 4 channels whose
database fits shared memory, else the tiled selection that
``knn_gather_extrema`` runs too; both return the same indices bit for bit.
``gather_extrema`` has two routes, chosen by shape alone
(``gather_extrema_route``): a column slice of the cloud staged in shared
memory, and for clouds whose slice does not fit, rows read through the
cache.  ``_knn`` and ``_gather_extrema`` force a route, for the checks.
``knn_gather_extrema``'s kernel scans a cloud's distinct database rows
only: each stands for its copies, which enter the neighbour lists where a
stable sort over all N rows puts them, so the indices are those of the full
scan.  While a profiler records, it adds the distances its kernel computes,
distinct query rows times distinct database rows, to the work counter
``K3_DISTANCES`` (``utils.profiling``), from the count of distinct rows the
launch leaves in its scratch, and the kernel adds the rows whose copies took
the tie path (another row's entry at their distance: the copies go in one
at a time) to ``K3_TIE_ROWS``.  With ``copy_lists=True`` it also returns
the distinct rows and copy lists its launch built (``DistinctRows``, views
of its scratch; None on the CPU), which kernel 9 walks in DGCNN's head.

The gathers follow ``--gather_precision`` where their TPU counterparts
split the values into bf16 planes (``parts``): at ``bf16`` (parts 1) each
value is rounded to bf16, to nearest even, and max and min are taken in
f32 on the rounded values, which is what the TPU's one bf16 plane gives.
``gather_extrema`` then reads a bf16 copy of the values (half the bytes of
the f32 rows; the launch counts under ``"gather_extrema:bf16"`` as well as
under its name); ``knn_gather_extrema``, bound by its selection, reads
the rounded values in f32.  ``parts=None`` takes the process's setting on
the card and exact gathers on the CPU (``precision.value_parts``).  The kNN
distances stay f32 at every setting: the JAX package pins them to HIGHEST.

``knn`` and ``knn_gather_extrema`` take the JAX package's kNN selection
setting (``select``; ``knn_gather_extrema`` also its ``layout``): each
class selects the k smallest keys made from the distances
(``precision.selection_keys``), ties to the lowest index.  The kernels form
the key where a distance is rounded, before any comparison, so both routes
and the distinct-row pass keep their rules.  ``select=None`` takes the
process's setting (``IQTPU_KNN_SELECT``) on the card and the exact one on
the CPU (``precision.knn_class``); the plain versions take the class
itself (``cls``).  A launch of the packed or bf16 class
counts under its route (``"knn:packed"``, ...) as well.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from ...utils import profiling
from ..geometry import index_points, sorted_topk_indices, square_distance
from ..precision import gather_values, knn_class, value_parts
from . import build
from .launch import (SELECT_CODES, I, P, check, count_launch, on_cpu,
                     raise_on, stream)

# the work counters of knn_gather_extrema (``utils.profiling.accumulator``):
# per launch, the sum over clouds of the distinct query rows times the
# distinct database rows the kernel scans for each; and the candidates, over
# every query, whose copies took the tie path
K3_DISTANCES = "k3_distances"
K3_TIE_ROWS = "k3_tie_rows"

MAX_K = 32      # largest neighbourhood the kernels take (kMaxK in the source)
MAX_QUERY_ROWS = 12288    # most query rows of a cloud (kMaxDistinctRows)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("neighbors")
    lib.iq_knn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.iq_knn_route.argtypes = [I, I, I, P]
    lib.iq_gather_extrema.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.iq_gather_extrema_route.argtypes = [I, I, I, I, P]
    lib.iq_knn_gather_extrema.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                          I, P]
    for fn in (lib.iq_knn, lib.iq_knn_route, lib.iq_gather_extrema,
               lib.iq_gather_extrema_route, lib.iq_knn_gather_extrema):
        fn.restype = ctypes.c_int
    return lib


class DistinctRows(NamedTuple):
    """Each cloud's distinct rows and their copies, as kernel 3's launch
    leaves them in its scratch (``csrc/knn_select.cuh`` ``DistinctRows``):
    cloud b's distinct row p is ``rows[b, p]`` (ascending, p below
    ``nrows[b]``), and it has ``starts[b, p + 1] - starts[b, p]`` copies,
    itself included.  All int32."""
    rows: torch.Tensor       # (B, N)
    nrows: torch.Tensor      # (B,)
    starts: torch.Tensor     # (B, N + 1)


def _distinct_rows_scratch(B: int, S: int, device,
                           copy_lists: bool = False) -> torch.Tensor:
    """Scratch of the selection kernels: each query row's first copy, the
    list of distinct rows and their count per cloud (the kernels select for
    the distinct query rows only; copies take their original's result);
    with ``copy_lists`` (kernel 3), each distinct row's copies besides."""
    n = B * (2 * S + 1)
    return torch.empty(2 * n if copy_lists else n, dtype=torch.int32,
                       device=device)


def _check_k(k: int, n: int):
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, N={n})]")


# --------------------------------------------------------------------- knn
# the route argument of iq_knn and iq_knn_density: chosen by shape, or one
# route forced
KNN_ROUTES = {"shape": 0, "xyz": 1, "tiled": 2}


def route_info(info) -> dict:
    """The record of a kNN route query (``knn_route``,
    ``groups.knn_density_route``)."""
    route, threads, blocks, smem, regs, local = info
    return {"route": "xyz" if route == KNN_ROUTES["xyz"] else "tiled",
            "threads": threads, "blocks_per_sm": blocks,
            "smem_bytes": smem, "registers": regs, "local_bytes": local}


def knn_plain(query: torch.Tensor, database: torch.Tensor, k: int,
              cls: str = "exact") -> torch.Tensor:
    """Plain version of ``knn`` at the selection class ``cls``: the
    distances in f32 at every matmul precision, as the kernel's."""
    return sorted_topk_indices(square_distance(query, database, "highest"), k,
                               cls)


def knn(query: torch.Tensor, database: torch.Tensor, k: int,
        select: Optional[str] = None) -> torch.Tensor:
    """The k nearest database rows of each query row.

    Args:
      query: (B, S, C) float32; database: (B, N, C) float32.
      select: a kNN selection setting (``config.KNN_SELECT_CLASSES``); None
        follows ``precision.knn_class``.
    Returns:
      (B, S, k) int32, ascending key of the setting's class (the distance
      itself at two_pass), ties to the lowest index.
    """
    cpu = on_cpu(query, database)
    cls = knn_class(select, cpu)
    if cpu:
        return knn_plain(query, database, k, cls)
    return _knn(query, database, k, KNN_ROUTES["shape"], cls)


def _knn(query: torch.Tensor, database: torch.Tensor, k: int, route: int,
         cls: str = "exact") -> torch.Tensor:
    """Launch iq_knn on ``route`` (``KNN_ROUTES``) at the selection class
    ``cls``: by shape, as ``knn`` does, or one route forced, to hold both
    routes against each other and the plain version at the same shapes."""
    check(query, "query", torch.float32, 3)
    check(database, "database", torch.float32, 3)
    B, S, C = query.shape
    if database.shape[0] != B or database.shape[2] != C:
        raise ValueError(f"query {tuple(query.shape)} and database "
                         f"{tuple(database.shape)} disagree")
    N = database.shape[1]
    _check_k(k, N)
    if S > MAX_QUERY_ROWS:
        raise ValueError(f"S={S} query rows per cloud (at most {MAX_QUERY_ROWS})")
    out = torch.empty((B, S, k), dtype=torch.int32, device=query.device)
    scratch = _distinct_rows_scratch(B, S, query.device)
    with record_function("iq_knn"):
        rc = _lib().iq_knn(query.data_ptr(), database.data_ptr(),
                           out.data_ptr(), scratch.data_ptr(), B, S, N, C, k,
                           route, SELECT_CODES[cls], stream(query))
    raise_on(rc, "iq_knn")
    count_launch("knn", cls)
    return out


def knn_route(N: int, C: int, k: int) -> dict:
    """The route ``knn`` takes for clouds of N database rows of C channels
    at k neighbours, its launch shape, how many of its blocks one SM of the
    current card holds, and its kernel's registers and local memory
    (``cudaFuncGetAttributes``).  Launches nothing."""
    info = (ctypes.c_int * 6)()
    raise_on(_lib().iq_knn_route(N, C, k, info), "iq_knn_route")
    return route_info(info)


# ---------------------------------------------------------- gather_extrema
# iq_gather_extrema's route argument: chosen by shape, or one route forced
ROUTES = {"shape": 0, "slice": 1, "rows": 2}


def gather_extrema_plain(idx: torch.Tensor, a: torch.Tensor, parts: int = 2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``gather_extrema`` at ``parts`` value planes."""
    g = index_points(gather_values(a, parts), idx)             # (B, S, k, F)
    return g.amax(dim=2), g.amin(dim=2)


def gather_extrema(idx: torch.Tensor, a: torch.Tensor,
                   parts: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point elementwise max and min of value rows over given neighbours.

    Args:
      idx: (B, S, k) int32 indices into the N rows of ``a``, each in [0, N).
      a:   (B, N, F) float32 value rows.
      parts: 2 exact values, 1 values rounded to bf16; None follows
        ``precision.value_parts``.
    Returns:
      (amax, amin), each (B, S, F) float32.

    Caller contract: every index lies in [0, N).  On a CUDA tensor the
    kernel reads ``a[idx]`` unchecked (a check would cost a reduction and a
    host sync per launch), so an index outside that range reads out of
    bounds; the plain version on the CPU raises instead.  The main path's
    indices come from ``knn``, which keeps them in range.
    """
    cpu = on_cpu(idx, a)
    parts = value_parts(parts, cpu)
    if cpu:
        return gather_extrema_plain(idx, a, parts)
    return _gather_extrema(idx, a, ROUTES["shape"], parts)


def _gather_extrema(idx: torch.Tensor, a: torch.Tensor, route: int,
                    parts: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch iq_gather_extrema on ``route`` (``ROUTES``): by shape, as
    ``gather_extrema`` does, or one route forced, to hold both routes
    against the plain version at the same shapes.  At ``parts`` 1 the
    kernel reads a bf16 copy of ``a`` (rounded to nearest even); an ``a``
    in bf16 is that copy already, which the checks use to time the kernel
    apart from the rounding."""
    check(idx, "idx", torch.int32, 3)
    check(a, "a", torch.bfloat16 if a.dtype == torch.bfloat16
          else torch.float32, 3)
    B, S, k = idx.shape
    N, F = a.shape[1], a.shape[2]
    if a.shape[0] != B:
        raise ValueError(f"idx {tuple(idx.shape)} and a {tuple(a.shape)} "
                         "disagree on the batch")
    _check_k(k, MAX_K)
    bf16 = parts == 1 or a.dtype == torch.bfloat16
    values = a.to(torch.bfloat16) if bf16 else a
    amax = torch.empty((B, S, F), dtype=torch.float32, device=a.device)
    amin = torch.empty_like(amax)
    with record_function("iq_gather_extrema"):
        rc = _lib().iq_gather_extrema(idx.data_ptr(), values.data_ptr(),
                                      amax.data_ptr(), amin.data_ptr(),
                                      B, S, N, F, k, route, int(bf16),
                                      stream(a))
    raise_on(rc, "iq_gather_extrema")
    count_launch("gather_extrema", "bf16" if bf16 else "f32")
    return amax, amin


def gather_extrema_route(N: int, F: int, k: int, parts: int = 2) -> dict:
    """The route ``gather_extrema`` takes for clouds of N rows of F values
    at k neighbours and ``parts`` value planes, and how many of its blocks
    one SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Launches
    nothing."""
    info = (ctypes.c_int * 4)()
    raise_on(_lib().iq_gather_extrema_route(N, F, k, int(parts == 1), info),
             "iq_gather_extrema_route")
    route, cols, threads, blocks = info
    return {"route": "slice" if route == ROUTES["slice"] else "rows",
            "slice_cols": cols, "threads": threads, "blocks_per_sm": blocks}


# ------------------------------------------------------ knn_gather_extrema
def knn_gather_extrema_plain(xs: torch.Tensor, a: torch.Tensor, k: int,
                             parts: int = 2, cls: str = "exact",
                             copy_lists: bool = False) -> tuple:
    """Plain version of ``knn_gather_extrema`` at ``parts`` value planes
    and the selection class ``cls``; it builds no copy lists (None with
    ``copy_lists``)."""
    out = gather_extrema_plain(knn_plain(xs, xs, k, cls), a, parts)
    return (*out, None) if copy_lists else out


def knn_gather_extrema(xs: torch.Tensor, a: torch.Tensor, k: int,
                       parts: Optional[int] = None,
                       select: Optional[str] = None,
                       layout: Optional[str] = None,
                       copy_lists: bool = False) -> tuple:
    """Per-point extrema of value rows over the k nearest neighbours in
    feature space; the (N, N) distances and the indices stay on chip.

    Args:
      xs: (B, N, C) float32 features defining the graph (self included).
      a:  (B, N, F) float32 value rows.
      parts: 2 exact values, 1 values rounded to bf16 (the kernel reads
        them rounded, in f32); None follows ``precision.value_parts``.
      select, layout: the kNN selection setting (at layout nq the packed
        class whatever ``select``); None follows ``precision.knn_class``.
      copy_lists: also return the launch's ``DistinctRows`` of xs (None on
        the CPU).
    Returns:
      (amax, amin), each (B, N, F) float32; with ``copy_lists``, (amax,
      amin, lists).
    """
    cpu = on_cpu(xs, a)
    parts = value_parts(parts, cpu)
    cls = knn_class(select, cpu, "knn_gather_extrema", layout)
    if cpu:
        return knn_gather_extrema_plain(xs, a, k, parts, cls, copy_lists)
    return _knn_gather_extrema(xs, a, k, parts, cls, copy_lists)


def _knn_gather_extrema(xs: torch.Tensor, a: torch.Tensor, k: int,
                        parts: int = 2, cls: str = "exact",
                        copy_lists: bool = False) -> tuple:
    """Launch iq_knn_gather_extrema at ``parts`` value planes and the
    selection class ``cls``; with ``copy_lists``, return its
    ``DistinctRows`` after the extrema."""
    check(xs, "xs", torch.float32, 3)
    check(a, "a", torch.float32, 3)
    B, N, C = xs.shape
    F = a.shape[2]
    if a.shape[:2] != xs.shape[:2]:
        raise ValueError(f"xs {tuple(xs.shape)} and a {tuple(a.shape)} "
                         "disagree")
    _check_k(k, N)
    if N > MAX_QUERY_ROWS:
        raise ValueError(f"N={N} rows per cloud (at most {MAX_QUERY_ROWS})")
    a = gather_values(a, parts)
    amax = torch.empty((B, N, F), dtype=torch.float32, device=a.device)
    amin = torch.empty_like(amax)
    scratch = _distinct_rows_scratch(B, N, xs.device, copy_lists=True)
    # the tie path's count, passed to the kernel only while a profiler
    # records
    tracing = profiling.tracing()
    ties = (profiling.accumulator(K3_TIE_ROWS, xs.device).data_ptr()
            if tracing else None)
    with record_function("iq_knn_gather_extrema"):
        rc = _lib().iq_knn_gather_extrema(xs.data_ptr(), a.data_ptr(),
                                          amax.data_ptr(), amin.data_ptr(),
                                          scratch.data_ptr(), ties, B, N, C, F,
                                          k, SELECT_CODES[cls], stream(xs))
    raise_on(rc, "iq_knn_gather_extrema")
    BN = B * N                  # the scratch's rows, nrows and starts
    lists = DistinctRows(scratch[BN:2 * BN].view(B, N),
                         scratch[2 * BN:2 * BN + B],
                         scratch[2 * BN + B:BN * 3 + 2 * B].view(B, N + 1))
    if tracing:                 # after the span: the kernel's time is its own
        nrows = lists.nrows.long()
        profiling.accumulator(K3_DISTANCES, xs.device).add_(
            (nrows * nrows).sum())
    count_launch("knn_gather_extrema", cls)
    return (amax, amin, lists) if copy_lists else (amax, amin)
