"""The arithmetic of the redesigned kernels, emulated in plain PyTorch: the
tensor-core products of ``csrc/groups.cu`` at each matmul precision (both
``fused_ball_mlp3``'s and ``fused_pointconv_sa``'s layers, the latter's
WeightNet and contraction), of ``csrc/knn_group.cu`` (kernel 10's
layer 2) and of ``csrc/group_mlp.cu`` (kernel 11's four layers), the
rounding of gathered values to bf16, the distance chain of
``csrc/knn_select.cuh``, the selection of the kNN kernels' xyz route
(``csrc/knn_xyz.cuh``), kernel 3's compacted scan (``select_knn`` with
kCompact, its copy lists included), kernel 9's walk of those lists
(``csrc/dense.cu``'s listed route) and the argmax of ``csrc/fps.cu``'s
register route.

At the ``highest`` matmul precision the kernels that run a matrix product on
the tensor cores keep f32 accuracy by splitting every f32 operand into two
TF32 values, x = hi + lo, and summing three products in f32:
lo @ w_hi + hi @ w_lo + hi @ w_hi.  Only lo @ w_lo, about 2**-22 of a
product, is dropped.  At ``high`` they take one product of the operands
rounded to TF32 (to nearest, ties away from zero, as ``cvt.rna.tf32.f32``);
at ``default`` one product of the operands rounded to bf16 (to nearest
even), which a TF32 product takes exactly: one bf16 pass with f32
accumulation.  Either keeps about three decimal digits.  Kernel 7's
WeightNet runs on the f32 units on the same rounded operands, and its
contraction keeps the three products at every setting.

Everything here is a second reference for the kernels' arithmetic, for the
tests and ``chip_smoke.py``; the rounding of bf16 operands and of gathered
values is ``ops.precision``'s, which the main path runs.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..geometry import index_points
from ..precision import gather_values, matmul, round_bf16, selection_keys

_LOW13 = 0x1FFF          # the 13 mantissa bits that TF32 does not keep


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor: ``hi`` is x with its low 13 mantissa
    bits cleared, ``lo`` is x - hi (exact in f32) rounded to TF32, to
    nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds."""
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32, got {x.dtype}")
    hi = (x.contiguous().view(torch.int32) & ~_LOW13).view(torch.float32)
    rest = (x - hi).contiguous().view(torch.int32)
    lo = ((rest + (_LOW13 + 1) // 2) & ~_LOW13).view(torch.float32)
    return hi, lo


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` and the kernels round."""
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + (_LOW13 + 1) // 2) & ~_LOW13).view(torch.float32)


def matmul_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the kernels compute it: three products of the TF32 halves,
    the small ones first, summed in f32."""
    x_hi, x_lo = split_tf32(x)
    w_hi, w_lo = split_tf32(w)
    return (torch.matmul(x_lo, w_hi) + torch.matmul(x_hi, w_lo)
            + torch.matmul(x_hi, w_hi))


def matmul_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One TF32 product: both operands rounded to TF32 (``round_tf32``),
    their products exact in f32, summed in f32."""
    return torch.matmul(round_tf32(x), round_tf32(w))


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One bf16 product: both operands rounded to bf16 (``round_bf16``),
    their products exact in x's dtype, summed in it."""
    return torch.matmul(round_bf16(x), round_bf16(w))


def matmul_rounded(x: torch.Tensor, w: torch.Tensor,
                   precision: str) -> torch.Tensor:
    """A product on the f32 units of operands rounded for ``precision``
    (kernel 7's WeightNet): f32 at ``highest``, TF32 operands at ``high``,
    bf16 operands at ``default``."""
    if precision == "highest":
        return torch.matmul(x, w)
    if precision == "high":
        return matmul_tf32(x, w)
    if precision == "default":
        return matmul_bf16(x, w)
    raise ValueError(f"unknown matmul precision {precision!r}")


def matmul_at(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """A tensor-core product of the kernels at ``precision``: the three
    TF32 products at ``highest``, else one product of rounded operands."""
    if precision == "highest":
        return matmul_3xtf32(x, w)
    return matmul_rounded(x, w, precision)


def mlp23_at(h: torch.Tensor, a2, b2, a3, b3, precision: str) -> torch.Tensor:
    """Layers 2 and 3 of ``fused_ball_mlp3`` and ``fused_pointconv_sa`` as
    their kernels compute them at ``precision``:
    relu(relu(h @ a2 + b2) @ a3 + b3)."""
    h = torch.relu(matmul_at(h, a2, precision) + b2)
    return torch.relu(matmul_at(h, a3, precision) + b3)


def mlp23_3xtf32(h: torch.Tensor, a2, b2, a3, b3) -> torch.Tensor:
    """Layers 2 and 3 on the split products (``mlp23_at`` at ``highest``)."""
    return mlp23_at(h, a2, b2, a3, b3, "highest")


def ball_mlp3_at(new_xyz, xyz, uf, b1, a1x, a2, b2, a3, b3, *, radius: float,
                 k: int, precision: str, parts: int = 2) -> torch.Tensor:
    """``fused_ball_mlp3`` as its kernel computes it: the plain version
    (``ops.cuda.groups.fused_ball_mlp3_plain``: the ball, layer 1 in f32 on
    the feature rows at ``parts``) with layers 2-3 at ``precision``."""
    from .groups import fused_ball_mlp3_plain
    return fused_ball_mlp3_plain(
        new_xyz, xyz, uf, b1, a1x, a2, b2, a3, b3, radius=radius, k=k,
        parts=parts, layers=lambda h: mlp23_at(h, a2, b2, a3, b3, precision))


def pointconv_sa_at(idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3,
                    dnet: Sequence, wnet: Sequence, *, k: int, precision: str,
                    parts: int = 2) -> torch.Tensor:
    """``fused_pointconv_sa`` as its kernel computes it: layer 1 on the
    gathered rows of u at ``parts`` and the density scale in f32, layers
    2-3 at ``precision``, WeightNet on the f32 units on operands rounded for
    ``precision``, and the scaled rows h3 contracted against the WeightNet
    outputs as the (C3, K) @ (K, 16) product per centre on the split
    products at every setting.  Arguments and result are those of
    ``ops.cuda.groups.fused_pointconv_sa_plain``."""
    from .groups import density_scale, weightnet
    B, S = idx.shape[:2]
    h = torch.relu(index_points(gather_values(u, parts), idx)
                   - csw[:, :, None, :])
    h3 = (mlp23_at(h, a2, b2, a3, b3, precision)
          * density_scale(den, dmax, dnet)[..., None])          # (B, S, K, C3)
    wt = weightnet(index_points(xyz, idx) - new_xyz[:, :, None, :], wnet,
                   product=lambda x, w: matmul_rounded(x, w, precision))
    return matmul_3xtf32(h3.transpose(-1, -2).contiguous(),
                         wt).reshape(B, S, -1)


def pointconv_sa_3xtf32(idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3,
                        dnet: Sequence, wnet: Sequence, *,
                        k: int) -> torch.Tensor:
    """``pointconv_sa_at`` at ``highest`` with exact gathers: layer 1, the
    density scale and WeightNet in f32, layers 2-3 and the contraction on
    the split products."""
    return pointconv_sa_at(idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3,
                           b3, dnet, wnet, k=k, precision="highest")


def knn_group_max_at(idx, u, c, a2, b2, *, precision: str,
                     parts: int = 2) -> torch.Tensor:
    """``knn_group_max`` as its kernel (kernel 10) computes it: layer 1's
    rows relu(u[idx] + c) in f32 on the gathered rows of u at ``parts``,
    layer 2 on the tensor cores at ``precision`` (``matmul_at``), then its
    bias, ReLU and the max over the slots.  Arguments and result are those
    of ``ops.cuda.knn_group.knn_group_max_plain``."""
    from .knn_group import knn_group_max_plain
    return knn_group_max_plain(
        idx, u, c, a2, b2, parts,
        product=lambda h, w: matmul_at(h, w, precision))


def group_res_mlp_at(idx, fps, u, c, sig, blocks, *, precision: str,
                     parts: int = 2) -> torch.Tensor:
    """``group_res_mlp`` as its kernel (kernel 11) computes it: h0 =
    relu(sig (u[idx] - u[fps]) + c) in f32 on the gathered rows of u at
    ``parts``, each residual block's two products on the tensor cores at
    ``precision`` (``matmul_at``), their biases, residual and ReLUs in
    f32, then the max over the slots.  Arguments and result are those of
    ``ops.cuda.group_mlp.group_res_mlp_plain``."""
    from .group_mlp import group_res_mlp_plain
    return group_res_mlp_plain(
        idx, fps, u, c, sig, blocks, parts,
        product=lambda h, w: matmul_at(h, w, precision))


def fps_register_route(xyz: torch.Tensor, npoint: int,
                       threads: int = 128) -> torch.Tensor:
    """Farthest-point sampling with the argmax of ``csrc/fps.cu``'s register
    route, step for step: thread t owns the points t, t + threads, ... (slots
    beyond N hold distance 0), scans them in ascending index with a strict
    ``>``, a warp takes the maximum of the distances' f32 bits as unsigned
    integers and the lowest index among the lanes that hold it, and the
    warps' candidates are folded the same way.  The distances are
    ``(dx*dx + dy*dy) + dz*dz`` with a running minimum from 1e10, as in
    ``ops.geometry.farthest_point_sample``.

    xyz (B, N, 3) float32 -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    ppt = -(-N // threads)
    slots = ppt * threads
    pad = torch.zeros(B, slots - N, 3, dtype=xyz.dtype)
    pts = torch.cat([xyz, pad], dim=1)
    dist = torch.cat([torch.full((B, N), 1e10, dtype=torch.float32),
                      torch.zeros(B, slots - N)], dim=1)
    index = torch.arange(slots).reshape(ppt, threads)            # [i, thread]
    far = torch.zeros(B, dtype=torch.long)
    out = torch.empty(B, npoint, dtype=torch.int32)
    big = torch.iinfo(torch.int64).max
    for it in range(npoint):
        out[:, it] = far.int()
        c = pts[torch.arange(B), far][:, None, :]
        dx, dy, dz = (pts - c).unbind(-1)
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        # distances are >= 0: their bits order as (unsigned) integers
        bits = dist.view(torch.int32).long().reshape(B, ppt, threads)
        # a thread: strict > in ascending i keeps the first maximum
        tbits = bits.max(dim=1).values                           # (B, threads)
        first = (bits == tbits[:, None]).int().argmax(dim=1)
        tidx = index[first, torch.arange(threads)]
        # a warp: max of the bits, lowest index among the lanes that hold it
        wb = tbits.reshape(B, -1, 32)
        wi = tidx.reshape(B, -1, 32)
        wmax = wb.max(dim=2).values
        wmin = torch.where(wb == wmax[..., None], wi, big).min(dim=2).values
        # every thread folds the warps' candidates the same way
        bmax = wmax.max(dim=1).values
        far = torch.where(wmax == bmax[:, None], wmin, big).min(dim=1).values
    return out


def square_distance_chain(query: torch.Tensor, db: torch.Tensor,
                          cls: str = "exact") -> torch.Tensor:
    """(|q|^2 - 2 q.d) + |d|^2 as ``select_knn`` rounds it: the dot product
    and both norms are one multiply-add chain over the channels in
    ascending order (here a plain multiply then add per channel; the
    kernel's is fused), every other step rounded on its own.  Identical
    database rows get bit-identical distances to a query, wherever they sit.
    Then the key of the selection class ``cls``
    (``precision.selection_keys``), which the kernels form from the
    rounded distance before any comparison.

    query (B, S, C), db (B, N, C) float32 -> (B, S, N) float32.
    """
    dot = torch.zeros(query.shape[0], query.shape[1], db.shape[1],
                      dtype=torch.float32, device=query.device)
    q2 = torch.zeros(query.shape[:2], dtype=torch.float32, device=query.device)
    d2 = torch.zeros(db.shape[:2], dtype=torch.float32, device=db.device)
    for c in range(query.shape[2]):
        dot = dot + query[:, :, c, None] * db[:, None, :, c]
        q2 = q2 + query[:, :, c] * query[:, :, c]
        d2 = d2 + db[:, :, c] * db[:, :, c]
    return selection_keys((q2[:, :, None] - 2.0 * dot) + d2[:, None, :], cls)


LANES = 32               # a warp: lane l takes candidates l, l + 32, ...
XYZ_BUFFER = 64          # survivors a warp's buffer holds (kXyzBuffer)
XYZ_SMALL_N = 512        # up to here 16 candidates a lane, else 32 (kXyzSmallN)
XYZ_DEEP_K = 24          # above it a lane hands the first list 2 keys (kXyzDeepK)
_NO_INDEX = torch.iinfo(torch.int32).max     # the index of an empty key


class XyzSelection(NamedTuple):
    """What ``select_knn_xyz`` returns: the indices, and per query how many
    candidates pass 2 let through and how many times the buffer was merged
    into the list before the end of the candidates."""
    idx: torch.Tensor          # (B, S, k) int32
    survivors: torch.Tensor    # (B, S) int64
    flushes: torch.Tensor      # (B, S) int64


def _key_sort(d: torch.Tensor, i: torch.Tensor):
    """Keys (d, i) sorted ascending along the last axis, distance first,
    then index."""
    o = torch.argsort(i, dim=-1, stable=True)
    d, i = d.gather(-1, o), i.gather(-1, o)
    o = torch.argsort(d, dim=-1, stable=True)
    return d.gather(-1, o), i.gather(-1, o)


def _key_less(ad, ai, bd, bi):
    return (ad < bd) | ((ad == bd) & (ai < bi))


def select_knn_xyz(query: torch.Tensor, db: torch.Tensor, k: int,
                   cls: str = "exact") -> XyzSelection:
    """The xyz route's selection (``csrc/knn_xyz.cuh`` ``xyz_select``) step
    for step, on ``square_distance_chain``'s distances at the selection
    class ``cls``, for every query at once.  Keys are (distance, index),
    compared as the kernel compares them (floats, so -0 == +0).

    Pass 1: lane l keeps the M smallest keys of its candidates l, l + 32,
    ... (M = 2 above k = 24, else 1); the 32 KL smallest of those 32 M keys
    (KL = ceil(k / 32)), sorted, are the first list, and its entry k - 1 the
    threshold.  Pass 2, segment by segment (32
    x 16 candidates up to N = 512, else 32 x 32): the candidates below the
    threshold that are not their lane's own list entries are marked; in
    rounds, the marked ones, lane by lane in ascending index, fill the
    buffer's free slots, each tested again against the threshold as it
    stands (one that fails takes its slot as an empty key); then while 32
    or more wait, the first 32 are merged into the list (its 32 KL smallest
    keys are kept), the rest move down and the threshold is read again.
    What is left is merged at the end.

    query (B, S, C), db (B, N, C) float32, k <= N -> ``XyzSelection``.
    """
    B, S, _ = query.shape
    N = db.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    kl = -(-k // LANES)
    m = 2 if k > XYZ_DEEP_K else 1
    seg = LANES * (16 if N <= XYZ_SMALL_N else 32)
    nseg = -(-N // seg)
    Q = B * S
    inf = float("inf")
    # + 0.0 turns -0 into +0: the kernel's float compares do not tell them apart
    dist = square_distance_chain(query, db, cls).reshape(Q, N) + 0.0
    d = torch.full((Q, nseg * seg), inf)
    d[:, :N] = dist
    ids = torch.arange(nseg * seg, dtype=torch.int64)
    ids = torch.where(ids < N, ids, _NO_INDEX).expand(Q, -1)

    # pass 1: each lane's m smallest keys (slots beyond N hold empty keys)
    lane_d = d.reshape(Q, -1, LANES).transpose(1, 2)            # (Q, lane, block)
    lane_i = ids.reshape(Q, -1, LANES).transpose(1, 2)
    own_d, own_i = (t[..., :m] for t in _key_sort(lane_d, lane_i))
    ld, li = (t[:, :LANES * kl] for t in _key_sort(own_d.reshape(Q, -1),
                                                     own_i.reshape(Q, -1)))
    own = (lane_i[..., None] == own_i[:, :, None, :]).any(-1)      # (Q, lane, block)
    own = own.transpose(1, 2).reshape(Q, -1)                       # candidate order

    buf_d = torch.full((Q, XYZ_BUFFER), inf)
    buf_i = torch.full((Q, XYZ_BUFFER), _NO_INDEX, dtype=torch.int64)
    count = torch.zeros(Q, dtype=torch.int64)
    survivors = torch.zeros(Q, dtype=torch.int64)
    flushes = torch.zeros(Q, dtype=torch.int64)
    rows = torch.arange(Q)[:, None].expand(-1, seg)

    def merge(ld, li, wd, wi):
        return tuple(t[:, :LANES * kl] for t in _key_sort(torch.cat([ld, wd], 1),
                                                          torch.cat([li, wi], 1)))

    def drain(ld, li, buf_d, buf_i, count, flushes):
        while True:
            full = count >= LANES
            if not bool(full.any()):
                return ld, li, buf_d, buf_i, count, flushes
            md, mi = merge(ld, li, buf_d[:, :LANES], buf_i[:, :LANES])
            ld = torch.where(full[:, None], md, ld)
            li = torch.where(full[:, None], mi, li)
            pad_d = torch.full_like(buf_d[:, LANES:], inf)
            pad_i = torch.full_like(buf_i[:, LANES:], _NO_INDEX)
            buf_d = torch.where(full[:, None], torch.cat([buf_d[:, LANES:], pad_d], 1), buf_d)
            buf_i = torch.where(full[:, None], torch.cat([buf_i[:, LANES:], pad_i], 1), buf_i)
            count = count - LANES * full
            flushes = flushes + full

    # pass 2
    for g in range(nseg):
        # the segment's candidates lane by lane, in ascending index per lane
        order = (torch.arange(seg).reshape(-1, LANES).t().reshape(-1)) + g * seg
        cd, ci, cown = d[:, order], ids[:, order], own[:, order]
        marked = (_key_less(cd, ci, ld[:, k - 1, None], li[:, k - 1, None])
                  & ~cown & (ci < N))
        survivors += marked.sum(1)
        rank = torch.cumsum(marked, 1) - 1
        total = marked.sum(1)
        done = torch.zeros(Q, dtype=torch.int64)
        while bool((done < total).any()):
            take = (marked & (rank >= done[:, None])
                    & (rank < (done + XYZ_BUFFER - count)[:, None]))
            keep = _key_less(cd, ci, ld[:, k - 1, None], li[:, k - 1, None])
            at = (count[:, None] + rank - done[:, None])[take]
            buf_d[rows[take], at] = torch.where(keep, cd, inf)[take]
            buf_i[rows[take], at] = torch.where(keep, ci, _NO_INDEX)[take]
            n = take.sum(1)
            done += n
            count += n
            ld, li, buf_d, buf_i, count, flushes = drain(ld, li, buf_d, buf_i, count,
                                                         flushes)
    md, mi = merge(ld, li, buf_d[:, :LANES], buf_i[:, :LANES])
    li = torch.where((count > 0)[:, None], mi, li)
    return XyzSelection(li[:, :k].reshape(B, S, k).to(torch.int32),
                        survivors.reshape(B, S), flushes.reshape(B, S))


class CopyLists(NamedTuple):
    """A cloud's distinct rows and their copies, as kernel 3's launch builds
    them (``csrc/knn_select.cuh`` ``copy_lists_kernel``): distinct row
    ``rows[p]`` has the copies ``copies[starts[p]:starts[p + 1]]``,
    ascending, itself first; ``first[n]`` is the lowest row equal to row n."""
    first: torch.Tensor      # (N,) int64
    rows: torch.Tensor       # (d,) int64, ascending
    starts: torch.Tensor     # (d + 1,) int64
    copies: torch.Tensor     # (N,) int64


def copy_lists(x: torch.Tensor) -> CopyLists:
    """The copy lists of one cloud x (N, C) float32, rows equal bit for bit
    forming a class, as the distinct-row pass compares them."""
    N = x.shape[0]
    n = torch.arange(N)
    _, inverse = torch.unique(x.contiguous().view(torch.int32), dim=0,
                              return_inverse=True)
    lowest = torch.full((int(inverse.max()) + 1,), N, dtype=torch.int64)
    first = lowest.scatter_reduce(0, inverse, n, "amin")[inverse]
    rows = torch.nonzero(first == n).flatten()
    place = torch.empty(N, dtype=torch.int64)
    place[rows] = torch.arange(len(rows))
    cls = place[first]
    starts = torch.zeros(len(rows) + 1, dtype=torch.int64)
    starts[1:] = torch.bincount(cls, minlength=len(rows)).cumsum(0)
    return CopyLists(first, rows, starts, torch.argsort(cls * N + n))


def dense_pool_listed(feats: Sequence[torch.Tensor], conv, bn,
                      lists: Sequence[CopyLists], product=matmul) -> torch.Tensor:
    """``dense.dense_pool_plain`` as kernel 9's listed route walks a
    batch: for each cloud, the max of conv5 by ``product``, the eval
    BatchNorm and LeakyReLU over its distinct rows only (``lists[b]``,
    ``copy_lists`` of the rows that are equal in every segment), and the sum
    of each distinct row's value times its number of copies, divided by N.
    The rows' values come from one product over the batch, as the plain
    version's do: a CPU product of fewer rows may round otherwise (a single
    row takes another BLAS routine), where the kernel's row does not depend
    on the rows beside it."""
    from ...models.common import bn_eval, leaky_relu02
    h = torch.cat(list(feats), dim=-1)                          # (B, N, K)
    w = conv.weight.reshape(conv.weight.shape[0], -1)           # (C, K)
    y = leaky_relu02(bn_eval(product(h, w.T), bn))              # (B, N, C)
    out = []
    for yb, cl in zip(y, lists):
        yd = yb[cl.rows]                                        # (d, C)
        copies = (cl.starts[1:] - cl.starts[:-1]).to(y.dtype)
        out.append(torch.cat([yd.amax(dim=0),
                              (copies[:, None] * yd).sum(dim=0) / y.shape[1]]))
    return torch.stack(out)                                     # (B, 2C)


class CompactSelection(NamedTuple):
    """What ``select_knn_compact`` returns: the indices, and per cloud the
    candidates (over its distinct query rows) whose copies took the tie path
    and the distances the scan computed."""
    idx: torch.Tensor          # (B, N, k) int32
    tie_rows: torch.Tensor     # (B,) int64
    distances: torch.Tensor    # (B,) int64


def select_knn_compact(xs: torch.Tensor, k: int,
                       cls: str = "exact") -> CompactSelection:
    """Kernel 3's compacted scan (``select_knn`` with kCompact) step for
    step, on ``square_distance_chain``'s distances at the selection class
    ``cls``: each distinct query row of a cloud against its distinct rows,
    in ascending order.  The first tile of 64 goes into the empty list of
    32 by rank (its rows of one copy and a finite distance, ``_key_sort``),
    then its rows of several copies; after it, 32 rows at a time against
    the (distance, index) of entry k - 1 as it stood before the 32, the 32's
    rows of one copy first (behind every key below it), then those of
    several.  A row of several copies goes in as one block where no entry
    has its distance, else (the tie path) one copy at a time.  A copy takes
    its original's list.

    xs (B, N, C) float32, k <= min(32, N) -> ``CompactSelection``.
    """
    B, N, _ = xs.shape
    if not 1 <= k <= min(LANES, N):
        raise ValueError(f"k={k} must lie in [1, min({LANES}, N={N})]")
    inf = float("inf")
    dist = square_distance_chain(xs, xs, cls) + 0.0
    lanes = torch.arange(LANES)
    idx = torch.empty(B, N, k, dtype=torch.int32)
    ties = torch.zeros(B, dtype=torch.int64)
    work = torch.zeros(B, dtype=torch.int64)

    def shift(v, by):              # entry e takes entry e - by (e >= by)
        return v.gather(1, (lanes - by).clamp(min=0).expand_as(v))

    def below(ld, li, d, j):       # keys (distance, index) below (d, j)
        return ((ld < d[:, None]) | ((ld == d[:, None]) & (li < j))).sum(1)

    def put(ld, li, go, pos, d, j):
        at = lanes[None] == pos[:, None]
        after = (lanes[None] > pos[:, None]) & go[:, None]
        at = at & go[:, None]
        ld = torch.where(at, d[:, None], torch.where(after, shift(ld, 1), ld))
        li = torch.where(at, j, torch.where(after, shift(li, 1), li))
        return ld, li

    def put_copies(ld, li, go, dp, cps):
        """A row of several copies cps at distances dp, where go; returns
        the lists and the rows that took the tie path."""
        tie = go & (ld == dp[:, None]).any(1)
        block = go & ~tie
        pos = (ld < dp[:, None]).sum(1)
        r = lanes[None] - pos[:, None]
        inside = block[:, None] & (r >= 0) & (r < len(cps))
        after = block[:, None] & (r >= len(cps))
        ld = torch.where(inside, dp[:, None],
                         torch.where(after, shift(ld, len(cps)), ld))
        li = torch.where(inside, cps[r.clamp(0, len(cps) - 1)],
                         torch.where(after, shift(li, len(cps)), li))
        for ji in cps.tolist():
            ld, li = put(ld, li, tie, below(ld, li, dp, ji), dp, ji)
        return ld, li, int(tie.sum())

    for b in range(B):
        cl = copy_lists(xs[b])
        q = cl.rows
        d = dist[b][q][:, q]                               # (Q, ND)
        Q, ND = d.shape
        work[b] = Q * ND
        counts = cl.starts[1:] - cl.starts[:-1]

        def copies_of(p):
            return cl.copies[int(cl.starts[p]):int(cl.starts[p + 1])][:LANES]
        # the first tile: rows of one copy by rank, then those of several
        n0 = min(2 * LANES, ND)
        one = (counts[:n0] == 1)[None] & (d[:, :n0] < inf)
        sd, si = _key_sort(torch.where(one, d[:, :n0], inf),
                           q[:n0].expand(Q, -1))
        ld = torch.full((Q, LANES), inf)
        li = torch.zeros((Q, LANES), dtype=torch.int64)
        m = min(LANES, n0)
        ld[:, :m] = sd[:, :m]
        li[:, :m] = torch.where(sd[:, :m] < inf, si[:, :m], 0)
        for p in range(n0):
            if counts[p] > 1:
                ld, li, n = put_copies(ld, li, d[:, p] < inf, d[:, p], copies_of(p))
                ties[b] += n
        for g in range(n0, ND, LANES):
            wd, wi = ld[:, k - 1].clone(), li[:, k - 1].clone()
            group = range(g, min(g + LANES, ND))
            for p in ([p for p in group if counts[p] == 1]
                      + [p for p in group if counts[p] > 1]):
                dp, j = d[:, p], int(q[p])
                go = (dp < wd) | ((dp == wd) & (j < wi))
                if not bool(go.any()):
                    continue
                if counts[p] == 1:
                    ld, li = put(ld, li, go, below(ld, li, dp, j), dp, j)
                else:
                    ld, li, n = put_copies(ld, li, go, dp, copies_of(p))
                    ties[b] += n
        lists = torch.empty(N, k, dtype=torch.int32)
        lists[q] = li[:, :k].to(torch.int32)
        idx[b] = lists[cl.first]
    return CompactSelection(idx, ties, work)
