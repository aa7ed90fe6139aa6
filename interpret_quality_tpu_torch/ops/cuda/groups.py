"""PointNet++ and PointConv set-abstraction kernels and the grouped row
gather, hand-written in CUDA C++ for Hopper (``csrc/groups.cu``), with their
plain PyTorch versions.

==========================  ==============================================
wrapper                     replaces (interpret_quality_tpu/ops/pallas/)
==========================  ==============================================
``fused_ball_mlp3``         ``groups.py`` ``fused_ball_mlp3`` /
                            ``_ball_mlp3_kernel``
``knn_with_density``        ``groups.py`` ``knn_with_density`` /
                            ``_knn_den_kernel``
``fused_pointconv_sa``      ``groups.py`` ``fused_pointconv_sa`` /
                            ``_pconv_kernel``
``gather_rows``             ``groups.py`` ``gather_rows`` /
                            ``_gather_rows_kernel``
==========================  ==============================================

Signatures and layouts are the JAX functions' (without their TPU knobs
``block_q`` and ``interpret``): kNN ties go to the lowest index, and
``knn_with_density`` takes the kNN selection setting ``select`` as
``neighbors.knn`` does (its launches at a class other than exact counted
under ``"knn_with_density:packed"``, ...),
and gathers are exact f32 unless ``parts`` (the JAX package's value planes,
``--gather_precision``) is 1: then the gathered feature values (kernel 5's
``uf`` rows, kernel 7's ``u`` rows, kernel 8's values) are each rounded to
bf16, to nearest even; xyz offsets are exact at every setting, as in the JAX
package.  ``parts=None`` takes the process's setting on the card and exact
gathers on the CPU (``precision.value_parts``).  The kernels of
``fused_ball_mlp3`` and ``fused_pointconv_sa`` run their layers 2-3 (and the
latter its contraction) on the tensor cores with the same instructions (the
former in a warp-specialised pipeline, its ball query and layer 1 beside
the products): at the ``highest`` matmul precision as three TF32 products that keep f32
accuracy, at ``high`` as one product of TF32-rounded operands, at
``default`` as one product of bf16-rounded operands, as the process's
``--matmul_precision`` says (``ops/cuda/emulation.py`` repeats each).
Kernel 7's WeightNet takes the same rounded operands on the f32 units, and
its contraction keeps the three products at every setting.  On the CPU the
plain versions compute f32 products at every setting.  ``knn_with_density`` takes ``neighbors.knn``'s two
routes by the same rule (``knn_density_route``), and ``_knn_with_density``
forces one, for the checks; on the xyz route it selects for the distinct
query rows only (FPS repeats a centre once a masked cloud has fewer
distinct points than centres), as ``neighbors.knn`` does.  As in the JAX package, the work around
each kernel stays plain PyTorch: the hoisted layer-1 rows the callers pass
in, and the DensityNet scale (``density_scale``).

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; there is no fallback.  Each launch
counts in the launch registry (``launch.count_launch``) and runs inside a
profiler span named after its launcher (``iq_ball_mlp3``, ...); a launch at
another setting than the exact one counts under its route as well
(``gather_rows:bf16``, ``fused_ball_mlp3:default``, ...).  While a profiler
records, ``fused_ball_mlp3``'s kernel adds the rows it multiplies to the work
counter ``K5_ROWS``, and the tiles its consumer warpgroups multiply and those
they found not yet written by its producer warpgroup to ``K5_TILES`` and
``K5_FRONT_WAITS`` (``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ... import config
from ...utils import profiling
from ..geometry import (index_points, query_ball_point, sorted_topk_indices,
                        square_distance)
from ..precision import gather_values, knn_class, value_parts
from . import build
from .launch import (PRECISION_CODES, SELECT_CODES, F, I, P, check,
                     count_launch, on_cpu, raise_on, stream)
from .neighbors import (KNN_ROUTES, MAX_QUERY_ROWS, _distinct_rows_scratch,
                        route_info)

# the work counter of fused_ball_mlp3 (``utils.profiling.accumulator``): the rows
# the kernel multiplies through layers 2-3, each centre's filled slots
# (without feature rows the fresh ones: no earlier point at its very
# coordinates), every centre counted, repeated ones too
K5_ROWS = "k5_rows"
# its pipeline's work counters: the 64-row tiles of layer-1 rows its consumer
# warpgroups multiplied through layers 2-3 (pads included), and those at
# which a consumer found the tile not yet written, so the producer's ball
# query and layer 1 set the pace there
K5_TILES = "k5_tiles"
K5_FRONT_WAITS = "k5_front_waits"

MAX_DENSITY_K = 64   # largest k of knn_with_density (kMaxDensityK)
MAX_BALL_K = 1024    # largest k of fused_ball_mlp3 (kMaxBatchRows)
BALL_TILE_ROWS = 64  # rows of fused_ball_mlp3's tiles through layers 2-3 (kK5Rows)
# (C2 / 32, C3 / 32) that the kernels of fused_ball_mlp3 and
# fused_pointconv_sa are instantiated for: each warp owns a quarter of a
# layer's columns in tiles of 8
BALL_TILES = ((1, 2), (2, 4), (3, 4), (4, 8))
MAX_PCONV_K = 64     # largest k of fused_pointconv_sa (kMaxPconvK)
WNET_WIDTHS = ((3, 8), (8, 8), (8, 16))    # WeightNet (in, out) per layer

Affine = Tuple[torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("groups")
    lib.iq_ball_mlp3.argtypes = [P] * 14 + [I] * 7 + [F, I, P]
    lib.iq_knn_density.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.iq_knn_density_route.argtypes = [I, I, I, P]
    lib.iq_pointconv_sa.argtypes = [P] * 13 + [I] * 8 + [P]
    lib.iq_gather_rows.argtypes = [P] * 3 + [I] * 5 + [P]
    for fn in (lib.iq_ball_mlp3, lib.iq_knn_density, lib.iq_knn_density_route,
               lib.iq_pointconv_sa,
               lib.iq_gather_rows):
        fn.restype = ctypes.c_int
    return lib


def _weight(t: torch.Tensor, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """A contiguous f32 weight of the given shape, on a 16-byte boundary
    (the kernels read weight rows as float4s); a sliced view is copied."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mlp23(h: torch.Tensor, a2, b2, a3, b3) -> torch.Tensor:
    h = torch.relu(torch.matmul(h, a2) + b2)
    return torch.relu(torch.matmul(h, a3) + b3)


# --------------------------------------------------------- fused_ball_mlp3
def fused_ball_mlp3_plain(new_xyz, xyz, uf, b1, a1x, a2, b2, a3, b3, *,
                          radius: float, k: int, parts: int = 2,
                          layers: Optional[Callable] = None) -> torch.Tensor:
    """Plain version of ``fused_ball_mlp3``: the ball's rows gathered into a
    (B, S, K, C) tensor (the feature rows at ``parts`` value planes), three
    folded layers in f32, max over the slots.  ``layers`` replaces layers
    2-3 (``emulation.ball_mlp3_at``)."""
    idx = query_ball_point(radius, k, xyz, new_xyz, "highest")  # (B, S, K)
    off = index_points(xyz, idx) - new_xyz[:, :, None, :]
    pre = torch.matmul(off, a1x) + b1
    if uf is not None:
        pre = pre + index_points(gather_values(uf, parts), idx)
    h = torch.relu(pre)
    h = _mlp23(h, a2, b2, a3, b3) if layers is None else layers(h)
    return h.amax(dim=2)


def fused_ball_mlp3(new_xyz: torch.Tensor, xyz: torch.Tensor,
                    uf: Optional[torch.Tensor], b1, a1x, a2, b2, a3, b3, *,
                    radius: float, k: int,
                    parts: Optional[int] = None) -> torch.Tensor:
    """One PointNet++ MSG branch: max over the K ball slots of
    relu(relu(relu(layer1) @ a2 + b2) @ a3 + b3), where
    layer1 = (xyz_j - new_xyz_s) @ a1x + b1 + uf_j.

    Args:
      new_xyz: (B, S, 3) centres; xyz: (B, N, 3) points.
      uf: (B, N, C1) hoisted feature rows (features @ A1[feature rows]), or
        None for a level without input features.
      b1 (C1,), a1x (3, C1): layer 1's bias and xyz-offset rows.
      a2 (C1, C2), b2, a3 (C2, C3), b3: folded layers 2 and 3.
      radius, k: the ball (in-ball: squared distance <= radius**2 in f32)
        and its slot count (the first k in-ball points in index order).
      parts: the value planes of the uf rows (``precision.value_parts``).
    Returns:
      (B, S, C3) float32.

    On a CUDA tensor layers 2 and 3 run on the tensor cores at the
    process's ``--matmul_precision`` (``config.matmul_precision``;
    ``ops/cuda/emulation.py`` repeats the arithmetic); at
    ``highest``, as three TF32 products that keep f32 accuracy, the result
    is within rtol 1e-4 / atol 1e-5 of the plain version, not bit-equal.
    The kernel takes C1 a power of two in [8, 256], (C2, C3) in
    ``BALL_TILES`` times 32 and k <= ``MAX_BALL_K``.
    """
    tensors = [new_xyz, xyz] + ([] if uf is None else [uf])
    cpu = on_cpu(*tensors)
    parts = value_parts(parts, cpu)
    if cpu:
        return fused_ball_mlp3_plain(new_xyz, xyz, uf, b1, a1x, a2, b2, a3, b3,
                                     radius=radius, k=k, parts=parts)
    precision = config.matmul_precision()
    check(new_xyz, "new_xyz", torch.float32, 3)
    check(xyz, "xyz", torch.float32, 3)
    B, S, _ = new_xyz.shape
    N = xyz.shape[1]
    C1, C2, C3 = a2.shape[0], a2.shape[1], a3.shape[1]
    if new_xyz.shape[2] != 3 or xyz.shape != (B, N, 3) or k < 1:
        raise ValueError(f"new_xyz {tuple(new_xyz.shape)}, xyz "
                         f"{tuple(xyz.shape)}, k={k}")
    if uf is not None:
        check(uf, "uf", torch.float32, 3)
        if uf.shape != (B, N, C1):
            raise ValueError(f"uf {tuple(uf.shape)} != {(B, N, C1)}")
        uf = gather_values(uf, parts)
        if uf.data_ptr() % 16:              # the kernel reads its rows as float4s
            uf = uf.clone()
    w = [_weight(b1, "b1", (C1,)), _weight(a1x, "a1x", (3, C1)),
         _weight(a2, "a2", (C1, C2)), _weight(b2, "b2", (C2,)),
         _weight(a3, "a3", (C2, C3)), _weight(b3, "b3", (C3,))]
    if (C1 not in (8, 16, 32, 64, 128, 256) or C2 % 32 or C3 % 32
            or (C2 // 32, C3 // 32) not in BALL_TILES or C1 + C2 + 4 < C3):
        raise ValueError(
            f"layer widths ({C1}, {C2}, {C3}): C1 must be a power of two in "
            f"[8, 256] with C1 + C2 + 4 >= C3, and "
            f"(C2, C3) one of {[(32 * a, 32 * b) for a, b in BALL_TILES]}")
    if k > MAX_BALL_K:
        raise ValueError(f"k={k} must be at most {MAX_BALL_K}")
    out = torch.empty((B, S, C3), dtype=torch.float32, device=xyz.device)
    # the batch counter (16 bytes), both layers' weights in the order the
    # kernel's fragments read them and, without uf, each point's first copy
    scratch = torch.empty(4 + C1 * C2 + C2 * C3 + (B * N if uf is None else 0),
                          dtype=torch.float32,
                          device=xyz.device)
    # the rows layers 2-3 multiply, the tiles and the waits for them,
    # counted by the kernel while a profiler records; otherwise it gets no
    # counters
    counts = ([profiling.accumulator(name, xyz.device).data_ptr()
               for name in (K5_ROWS, K5_TILES, K5_FRONT_WAITS)]
              if profiling.tracing() else [None] * 3)
    with record_function("iq_ball_mlp3"):
        rc = _lib().iq_ball_mlp3(new_xyz.data_ptr(), xyz.data_ptr(),
                                 None if uf is None else uf.data_ptr(),
                                 *[t.data_ptr() for t in w], out.data_ptr(),
                                 scratch.data_ptr(), *counts,
                                 B, S, N, k, C1, C2, C3,
                                 radius ** 2, PRECISION_CODES[precision],
                                 stream(xyz))
    raise_on(rc, "iq_ball_mlp3")
    count_launch("fused_ball_mlp3", precision)
    return out


# -------------------------------------------------------- knn_with_density
def knn_with_density_plain(query, database, inv_density, k: int,
                           cls: str = "exact"):
    """Plain version of ``knn_with_density`` at the selection class
    ``cls``."""
    idx = sorted_topk_indices(square_distance(query, database, "highest"), k,
                              cls)
    den = index_points(inv_density[..., None], idx)[..., 0]
    return idx, den, den.amax(dim=-1, keepdim=True)


def knn_with_density(query: torch.Tensor, database: torch.Tensor,
                     inv_density: torch.Tensor, k: int,
                     select: Optional[str] = None):
    """kNN indices, each neighbour's inverse density, and the per-query max.

    Args:
      query: (B, S, C); database: (B, N, C); inv_density: (B, N); float32.
      select: a kNN selection setting; None follows
        ``precision.knn_class``.
    Returns:
      idx (B, S, k) int32 (ascending key of the setting's class, ties to
      the lowest index), den (B, S, k) float32, dmax (B, S, 1) float32.
    """
    cpu = on_cpu(query, database, inv_density)
    cls = knn_class(select, cpu, "knn_with_density")
    if cpu:
        return knn_with_density_plain(query, database, inv_density, k, cls)
    return _knn_with_density(query, database, inv_density, k,
                             KNN_ROUTES["shape"], cls)


def _knn_with_density(query: torch.Tensor, database: torch.Tensor,
                      inv_density: torch.Tensor, k: int, route: int,
                      cls: str = "exact"):
    """Launch iq_knn_density on ``route`` (``neighbors.KNN_ROUTES``) at the
    selection class ``cls``: by shape, as ``knn_with_density`` does, or one
    route forced."""
    check(query, "query", torch.float32, 3)
    check(database, "database", torch.float32, 3)
    check(inv_density, "inv_density", torch.float32, 2)
    B, S, C = query.shape
    N = database.shape[1]
    if database.shape != (B, N, C) or inv_density.shape != (B, N):
        raise ValueError(f"query {tuple(query.shape)}, database "
                         f"{tuple(database.shape)} and inv_density "
                         f"{tuple(inv_density.shape)} disagree")
    if not 1 <= k <= min(MAX_DENSITY_K, N):
        raise ValueError(f"k={k} must lie in [1, min({MAX_DENSITY_K}, N={N})]")
    idx = torch.empty((B, S, k), dtype=torch.int32, device=query.device)
    den = torch.empty((B, S, k), dtype=torch.float32, device=query.device)
    dmax = torch.empty((B, S, 1), dtype=torch.float32, device=query.device)
    # the xyz route selects for the distinct query rows only, given scratch
    scratch = (_distinct_rows_scratch(B, S, query.device)
               if S <= MAX_QUERY_ROWS else None)
    with record_function("iq_knn_density"):
        rc = _lib().iq_knn_density(
            query.data_ptr(), database.data_ptr(), inv_density.data_ptr(),
            idx.data_ptr(), den.data_ptr(), dmax.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, S, N, C, k,
            route, SELECT_CODES[cls], stream(query))
    raise_on(rc, "iq_knn_density")
    count_launch("knn_with_density", cls)
    return idx, den, dmax


def knn_density_route(N: int, C: int, k: int) -> dict:
    """The route ``knn_with_density`` takes for N database rows of C
    channels at k neighbours, as ``neighbors.knn_route`` tells it for
    ``knn``.  Launches nothing."""
    info = (ctypes.c_int * 6)()
    raise_on(_lib().iq_knn_density_route(N, C, k, info),
             "iq_knn_density_route")
    return route_info(info)


# ------------------------------------------------------ fused_pointconv_sa
def density_scale(den: torch.Tensor, dmax: torch.Tensor,
                  dnet: Sequence[Affine]) -> torch.Tensor:
    """DensityNet 1 -> 16 -> 8 -> 1 (folded, ReLU after every layer: the
    reference's sigmoid branch is dead code) on den / dmax: (B, S, K)."""
    (d1, e1), (d2, e2), (d3, e3) = dnet
    x = (den / dmax)[..., None]
    x = torch.relu(x * d1[0] + e1)
    x = torch.relu(torch.matmul(x, d2) + e2)
    return torch.relu(torch.matmul(x, d3) + e3)[..., 0]


def weightnet(off: torch.Tensor, wnet: Sequence[Affine],
              product: Callable = torch.matmul) -> torch.Tensor:
    """WeightNet 3 -> 8 -> 8 -> 16 (folded, ReLU after every layer), its
    products by ``product`` (``emulation.matmul_rounded`` for the kernel's
    at another precision)."""
    for a, b in wnet:
        off = torch.relu(product(off, a) + b)
    return off


def fused_pointconv_sa_plain(idx, den, dmax, new_xyz, u, xyz, csw,
                             a2, b2, a3, b3, dnet, wnet, *, k: int,
                             parts: int = 2):
    """Plain version of ``fused_pointconv_sa``, the rows of u gathered at
    ``parts`` value planes."""
    B, S = idx.shape[:2]
    h = torch.relu(index_points(gather_values(u, parts), idx)
                   - csw[:, :, None, :])
    h = _mlp23(h, a2, b2, a3, b3) * density_scale(den, dmax, dnet)[..., None]
    wt = weightnet(index_points(xyz, idx) - new_xyz[:, :, None, :], wnet)
    return torch.einsum("bskc,bskw->bscw", h, wt).reshape(B, S, -1)


def fused_pointconv_sa(idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3,
                       dnet: Sequence[Affine], wnet: Sequence[Affine], *,
                       k: int, parts: Optional[int] = None) -> torch.Tensor:
    """PointConv SA grouped compute, after ``knn_with_density``:
    out[s, c*16 + w] = sum_j h[j, c] * wt[j, w] with
    h = relu(relu(relu(u[idx_j] - csw_s) @ a2 + b2) @ a3 + b3) * ds_j and
    wt = WeightNet(xyz[idx_j] - new_xyz_s).

    Args:
      idx/den/dmax: from knn_with_density.
      new_xyz: (B, S, 3); u: (B, N, C1) hoisted layer-1 rows
        (src @ A1 + b1); xyz: (B, N, 3); csw: (B, S, C1) = new_xyz @ A1[:3].
      a2/b2/a3/b3: folded layers 2-3.
      dnet / wnet: three folded (A, b) affines each, DensityNet (1->16->8->1)
        and WeightNet (3->8->8->16).
      parts: the value planes of the u rows (``precision.value_parts``).
    Returns:
      (B, S, C3*16) float32, the reference's C-major flattened
      einsum("bskc,bskw->bscw").

    On a CUDA tensor layers 2 and 3 run on the tensor cores and WeightNet
    on the f32 units at the process's ``--matmul_precision``
    (``config.matmul_precision``), the contraction on the tensor cores
    as three TF32 products at every setting (``ops/cuda/emulation.py``
    repeats the arithmetic); at ``highest`` the result is within rtol 1e-4
    / atol 1e-5 of the plain version, not bit-equal.  The
    kernel takes C1 a power of two in [8, 256], (C2, C3) in ``BALL_TILES``
    times 32 with C3 <= C1 + C2 (the model's (64, 64, 128) and
    (128, 128, 256) among them) and any k in [1, ``MAX_PCONV_K``] (the
    model's 32 and 64; 128 // k whole centres make a tile); anything else
    raises ``ValueError``.
    """
    cpu = on_cpu(idx, den, dmax, new_xyz, u, xyz, csw)
    parts = value_parts(parts, cpu)
    if cpu:
        return fused_pointconv_sa_plain(idx, den, dmax, new_xyz, u, xyz, csw,
                                        a2, b2, a3, b3, dnet, wnet, k=k,
                                        parts=parts)
    precision = config.matmul_precision()
    check(idx, "idx", torch.int32, 3)
    for t, name in ((new_xyz, "new_xyz"), (u, "u"), (xyz, "xyz"),
                    (csw, "csw")):
        check(t, name, torch.float32, 3)
    B, S, K = idx.shape
    N, C1 = u.shape[1], u.shape[2]
    C2, C3 = a2.shape[1], a3.shape[1]
    if (K != k or not 1 <= k <= MAX_PCONV_K or den.shape != (B, S, K)
            or dmax.shape != (B, S, 1) or new_xyz.shape != (B, S, 3)
            or u.shape != (B, N, C1) or xyz.shape != (B, N, 3)
            or csw.shape != (B, S, C1)):
        raise ValueError(f"k={k} (at most {MAX_PCONV_K}) and the shapes of "
                         f"idx {tuple(idx.shape)}, u {tuple(u.shape)}, xyz "
                         f"{tuple(xyz.shape)}, csw {tuple(csw.shape)} disagree")
    if (C1 not in (8, 16, 32, 64, 128, 256) or C2 % 32 or C3 % 32
            or (C2 // 32, C3 // 32) not in BALL_TILES or C1 + C2 < C3):
        raise ValueError(
            f"layer widths ({C1}, {C2}, {C3}): C1 must be a power of two in "
            f"[8, 256] with C1 + C2 >= C3, and "
            f"(C2, C3) one of {[(32 * a, 32 * b) for a, b in BALL_TILES]}")
    w = [_weight(a2, "a2", (C1, C2)), _weight(b2, "b2", (C2,)),
         _weight(a3, "a3", (C2, C3)), _weight(b3, "b3", (C3,))]
    packed = []
    for (a, b), (cin, cout) in zip(wnet, WNET_WIDTHS):
        packed += [_weight(a, "wnet", (cin, cout)).reshape(-1),
                   _weight(b, "wnet bias", (cout,))]
    packed = torch.cat(packed)
    ds = density_scale(den, dmax, dnet).contiguous()
    u = gather_values(u, parts)
    if u.data_ptr() % 16:                   # the kernel reads rows as float4s
        u = u.clone()
    if csw.data_ptr() % 16:
        csw = csw.clone()
    out = torch.empty((B, S, C3 * 16), dtype=torch.float32, device=u.device)
    # both layers' weights in the order the kernel's fragments read them
    scratch = torch.empty(C1 * C2 + C2 * C3, dtype=torch.float32,
                          device=u.device)
    with record_function("iq_pointconv_sa"):
        rc = _lib().iq_pointconv_sa(idx.data_ptr(), ds.data_ptr(),
                                    new_xyz.data_ptr(), u.data_ptr(),
                                    xyz.data_ptr(), csw.data_ptr(),
                                    *[t.data_ptr() for t in w],
                                    packed.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), B, S, N, K,
                                    C1, C2, C3, PRECISION_CODES[precision],
                                    stream(u))
    raise_on(rc, "iq_pointconv_sa")
    count_launch("fused_pointconv_sa", precision)
    return out


# ------------------------------------------------------------- gather_rows
def gather_rows_plain(values: torch.Tensor, idx: torch.Tensor,
                      parts: int = 2) -> torch.Tensor:
    """Plain version of ``gather_rows``: ``index_points`` (``torch.gather``)
    of the values at ``parts`` value planes."""
    return index_points(gather_values(values, parts), idx)


def gather_rows(values: torch.Tensor, idx: torch.Tensor,
                parts: Optional[int] = None) -> torch.Tensor:
    """Grouped row gather: out[b, s, j, :] = values[b, idx[b, s, j], :],
    an exact f32 copy, or at ``parts`` 1 each value rounded to bf16 (the
    kernel then reads a bf16 copy of the values: half their bytes).

    Every index must lie in [0, N).  The JAX package's Pallas kernel writes
    zeros for one outside (its one-hot row is empty), the plain version
    (``torch.gather``) raises, and the CUDA kernel does not check: it reads
    outside the cloud's rows.

    Args:
      values: (B, N, F) float32; idx: (B, S, K) int32.
      parts: 2 exact values, 1 values rounded to bf16; None follows
        ``precision.value_parts``.
    Returns:
      (B, S, K, F) float32.
    """
    cpu = on_cpu(values, idx)
    parts = value_parts(parts, cpu)
    if cpu:
        return gather_rows_plain(values, idx, parts)
    # values in bf16 are the rounded copy already (the checks time the
    # kernel apart from the rounding)
    check(values, "values", torch.bfloat16 if values.dtype == torch.bfloat16
          else torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    B, N, F = values.shape
    S, K = idx.shape[1], idx.shape[2]
    if idx.shape[0] != B:
        raise ValueError(f"values {tuple(values.shape)} and idx "
                         f"{tuple(idx.shape)} disagree on B")
    bf16 = parts == 1 or values.dtype == torch.bfloat16
    src = values.to(torch.bfloat16) if bf16 else values
    out = torch.empty((B, S, K, F), dtype=torch.float32, device=values.device)
    with record_function("iq_gather_rows"):
        rc = _lib().iq_gather_rows(src.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), B, N, S * K, F, int(bf16),
                                   stream(values))
    raise_on(rc, "iq_gather_rows")
    count_launch("gather_rows", "bf16" if bf16 else "f32")
    return out
